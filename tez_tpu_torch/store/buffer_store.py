"""Tiered shuffle buffer store: device memory -> host RAM -> disk, with
leases.

Exoshuffle (arXiv:2203.05072) makes the case that shuffle scales and
pipelines when its bytes live in a shared, capacity-governed object store
instead of bespoke per-operator files; this module is that store for the
data plane.  Three capacity-accounted tiers:

DEVICE  a sorted run's key lanes kept on the task's device
        (``KVBatch.dev_keys``: int32 lanes and lengths, torch tensors) so a
        same-process consumer's merge-path kernel ranks them in place,
        with no re-upload.  An entry here also holds its host arrays; the
        device pool accounts only the lane bytes.
HOST    the run's columnar numpy arrays, served as zero-copy views.
DISK    a partition-indexed ``.prun`` file (``FileRun``); partitions
        stream back block-at-a-time.

Entries are reference counted two ways: ``refs`` counts registry keys
aliased to the entry (a live DAG path plus, after sealing, a lineage key),
``leases`` counts in-flight readers.  LRU demotion cascades a tier above
its high watermark down to its low watermark — DEVICE drops the lanes,
HOST spills to a ``.prun`` file — and NEVER touches a leased entry, so a
reader's views and file handles stay valid for the whole lease.  Disk
eviction only ever removes sealed lineage entries (cold cache); live DAG
outputs are never dropped.

Device memory and streams.  Dropping an entry's lanes only drops the
store's reference: the CUDA caching allocator frees the blocks when the
last tensor referring to them goes, and hands them back per stream.  A
kernel that reads lent lanes on another stream is safe because every
consumer records its stream on them before it launches:
``ops/device.py`` ``merge_resident_slices`` calls ``record_stream`` with
its current stream on each slice's lanes and lengths, so a block the
store lets go is not reused until that merge's work on the card is done.
(The producer's side needs nothing: its lanes were read back through the
span's own event before the run was published.)  Demotion never touches
a leased entry either, so lanes are never dropped under a reader that
holds a lease.

Keys are epoch fenced exactly like the shuffle registry: a publish stamped
with a stale AM epoch raises ``EpochFencedError`` (zombie fencing
extended to stored segments), and sealed lineage entries remember their
epoch so a reuse probe from a superseded incarnation misses.

The port's copy of tez_tpu.store.buffer_store.
"""
from __future__ import annotations

import os
import tempfile
import threading
import uuid
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import time

from tez_tpu_torch.common import epoch as epoch_registry
from tez_tpu_torch.common import metrics
from tez_tpu_torch.common.epoch import EpochFencedError, WindowFencedError
from tez_tpu_torch.obs import flight as _flight
from tez_tpu_torch.ops.runformat import (FileRun, KVBatch, Run,
                                         save_run_partitioned)

DEVICE, HOST, DISK = "device", "host", "disk"
TIERS = (DEVICE, HOST, DISK)

#: Registry prefix for sealed cross-DAG lineage aliases.  Never collides
#: with DAG path components (those start with the DAG id).
LINEAGE_PREFIX = "__lineage__/"

#: TezCounters group the call-site counter mirror writes into (read back
#: by tools/counter_diff.py's store section).
COUNTER_GROUP = "ShuffleStore"


class StoreKeyNotFound(Exception):
    pass


class StoreQuotaExceeded(Exception):
    """A publish would take its tenant over a per-tenant tier quota.

    Isolation, not correctness: the producer falls back to its own spill
    files / the bare registry, so the DAG still completes — it just stops
    consuming shared store capacity."""

    def __init__(self, tenant: str, tier: str, used: int, quota: int):
        super().__init__(
            f"tenant {tenant or '<anon>'} over {tier} quota "
            f"({used} + publish > {quota} bytes)")
        self.tenant = tenant
        self.tier = tier


def _dev_nbytes(run: Any) -> int:
    """Device bytes held by a run's key lanes (0 when none).  dev_keys is
    (lanes, lengths, lo, hi): the filter keeps the two tensors' nbytes and
    skips the ints."""
    batch = getattr(run, "batch", None)
    dev = getattr(batch, "dev_keys", None)
    if dev is None:
        return 0
    return sum(int(getattr(a, "nbytes", 0)) for a in dev
               if hasattr(a, "nbytes"))


class StoreEntry:
    """One stored run + its tier/lease/refcount bookkeeping."""

    __slots__ = ("run", "tier", "host_nbytes", "dev_nbytes", "leases",
                 "refs", "epoch", "app_id", "lineage", "last_access",
                 "dead", "keys", "tenant", "sealed_at")

    def __init__(self, run: Any, tier: str, clock: Callable[[], float],
                 epoch: int, app_id: str, lineage: str, tenant: str = ""):
        self.run = run
        self.tier = tier
        self.host_nbytes = int(run.nbytes) if tier != DISK else 0
        self.dev_nbytes = _dev_nbytes(run) if tier == DEVICE else 0
        self.leases = 0
        self.refs = 0
        self.epoch = epoch
        self.app_id = app_id
        self.lineage = lineage
        self.tenant = tenant
        self.last_access = clock()
        self.dead = False
        self.sealed_at = 0.0                    # result-cache TTL anchor
        self.keys: List[Tuple[str, int]] = []   # registry aliases


class ShuffleBufferStore:
    """Capacity-governed three-tier object store for shuffle runs.

    Thread model: one reentrant-free Lock guards the registry and byte
    accounting; demotion IO (host -> disk spill) runs OUTSIDE the lock
    with the victim claimed by a synthetic lease, so publishes and fetches
    never stall behind a disk write.
    """

    def __init__(self, device_capacity: int = 256 << 20,
                 host_capacity: int = 1024 << 20,
                 disk_capacity: int = 0,
                 disk_dir: str = "",
                 high_watermark: float = 0.90,
                 low_watermark: float = 0.70,
                 clock: Callable[[], float] = time.time,
                 tenant_device_quota: int = 0,
                 tenant_host_quota: int = 0,
                 tenant_disk_quota: int = 0,
                 result_cache_ttl: float = 0.0,
                 result_cache_bytes: int = 0,
                 result_cache_admit: str = "always"):
        self.device_capacity = int(device_capacity)
        self.host_capacity = int(host_capacity)
        self.disk_capacity = int(disk_capacity)
        self._own_dir = not disk_dir
        self.disk_dir = disk_dir or tempfile.mkdtemp(prefix="tez-store-")
        self.high = float(high_watermark)
        self.low = float(low_watermark)
        # per-tenant isolation: the same byte cap applies to EVERY tenant
        # on each tier (0 = unlimited); quotas gate fresh publishes only —
        # capacity-driven demotion stays tenant-blind so the global
        # watermarks always win
        self.tenant_quota = {DEVICE: int(tenant_device_quota),
                             HOST: int(tenant_host_quota),
                             DISK: int(tenant_disk_quota)}
        # governed result cache (sealed lineage): TTL, per-tenant byte cap
        # (evicts least-recently-hit first), and seal-time admission policy
        self.result_cache_ttl = float(result_cache_ttl)
        self.result_cache_bytes = int(result_cache_bytes)
        self.result_cache_admit = str(result_cache_admit or "always")
        self._lineage_seen: Dict[str, float] = {}   # second-use admission
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, int], StoreEntry] = {}
        self._bytes = {DEVICE: 0, HOST: 0, DISK: 0}
        self._tenant_bytes: Dict[str, Dict[str, int]] = {}
        self.counters: Dict[str, int] = {
            "store.published": 0, "store.hits": 0, "store.misses": 0,
            "store.lineage.hits": 0, "store.lineage.misses": 0,
            "store.lineage.sealed": 0,
            "store.demotions.device_to_host": 0,
            "store.demotions.host_to_disk": 0,
            "store.evictions.device": 0, "store.evictions.host": 0,
            "store.evictions.disk": 0,
            "store.quota.device_demoted": 0,
            "store.quota.rejected.host": 0, "store.quota.rejected.disk": 0,
            "store.result_cache.expired": 0,
            "store.result_cache.evicted": 0,
            "store.result_cache.deferred": 0,
            # coded push replicas (docs/recovery.md): bytes landed on buddy
            # keys, and fetches served from a buddy after the primary entry
            # was lost — each failover is a producer re-run avoided
            "store.replica.bytes": 0, "store.replica.failover": 0,
        }

    # -- accounting helpers (call with lock held) ----------------------------

    def _account(self, entry: StoreEntry, sign: int) -> None:
        tb = self._tenant_bytes.setdefault(
            entry.tenant, {DEVICE: 0, HOST: 0, DISK: 0})
        if entry.tier == DEVICE:
            self._bytes[DEVICE] += sign * entry.dev_nbytes
            self._bytes[HOST] += sign * entry.host_nbytes
            tb[DEVICE] += sign * entry.dev_nbytes
            tb[HOST] += sign * entry.host_nbytes
        elif entry.tier == HOST:
            self._bytes[HOST] += sign * entry.host_nbytes
            tb[HOST] += sign * entry.host_nbytes
        else:
            self._bytes[DISK] += sign * int(entry.run.nbytes)
            tb[DISK] += sign * int(entry.run.nbytes)

    def _publish_gauges(self) -> None:
        for tier in TIERS:
            metrics.set_gauge(f"store.{tier}.bytes", self._bytes[tier])
        metrics.set_gauge("store.entries", len(self._entries))
        for tenant, tb in self._tenant_bytes.items():
            metrics.set_gauge(
                f"store.tenant.{tenant or 'default'}.bytes",
                float(sum(tb.values())))

    def _bump(self, name: str, counters: Any = None, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n
        if counters is not None:
            counters.group(COUNTER_GROUP).find_counter(name).increment(n)

    def note_replica_failover(self, detail: str = "",
                              counters: Any = None) -> None:
        """Account one primary->buddy failover (ShuffleService's fetch
        chain calls this when a lost primary entry is served from its
        coded replica key instead of re-running the producer)."""
        self._bump("store.replica.failover", counters)
        _flight.record(_flight.STORE, "replica.failover", detail)

    # -- producer side -------------------------------------------------------

    def publish(self, path_component: str, spill_id: int, run: Any,
                epoch: int = 0, app_id: str = "", lineage: str = "",
                tenant: str = "", counters: Any = None,
                replica: bool = False, window_id: int = 0,
                stream: str = "") -> None:
        """Insert a run under (path_component, spill_id).

        Epoch-fenced like ShuffleService.register: a stamped publish from
        a superseded AM incarnation raises instead of resurrecting zombie
        output.  ``lineage`` tags the entry for session-mode sealing;
        ``tenant`` charges the bytes to that tenant's quota (device
        over-quota lands on host instead; host/disk over-quota raise
        :class:`StoreQuotaExceeded` — the producer keeps its own copy).
        ``replica=True`` marks a coded buddy copy of an already-published
        run (accounted under store.replica.bytes; docs/recovery.md).
        A stamped publish from a *sealed streaming window* is fenced the
        same way (WindowFencedError) — window N's stragglers can never
        contaminate window N+1's store state."""
        if epoch > 0 and epoch_registry.is_stale(app_id, epoch):
            raise EpochFencedError(
                f"store publish from stale epoch {epoch} "
                f"(current {epoch_registry.current(app_id)}): "
                f"{path_component}/{spill_id}")
        if epoch_registry.is_stale_window(app_id, stream, window_id):
            from tez_tpu_torch.common import faults as _faults
            _faults.fire("fence.stale_window",
                         detail=f"store.publish {path_component}")
            raise WindowFencedError(
                f"store publish from stale window {window_id} of stream "
                f"{stream} (current "
                f"{epoch_registry.current_window(app_id, stream)}): "
                f"{path_component}/{spill_id}")
        tenant = str(tenant or "")
        if isinstance(run, FileRun):
            tier = DISK
        elif _dev_nbytes(run) > 0 and self.device_capacity > 0:
            tier = DEVICE
            if self._tenant_over(tenant, DEVICE, _dev_nbytes(run)):
                # device isolation is soft: the run is still admitted,
                # just without its lanes — consumers re-encode on demand
                run = self._drop_lanes(run)
                tier = HOST
                self._bump("store.quota.device_demoted", counters)
        else:
            if _dev_nbytes(run) > 0:
                run = self._drop_lanes(run)
            tier = HOST
        if tier == HOST and self._tenant_over(tenant, HOST,
                                              int(run.nbytes)):
            self._bump("store.quota.rejected.host", counters)
            raise StoreQuotaExceeded(tenant, HOST,
                                     self._tenant_used(tenant, HOST),
                                     self.tenant_quota[HOST])
        if tier == DISK and self._tenant_over(tenant, DISK,
                                              int(run.nbytes)):
            # make room from the tenant's own cold cache before refusing
            self._evict_tenant_lineage(tenant, int(run.nbytes), counters)
            if self._tenant_over(tenant, DISK, int(run.nbytes)):
                self._bump("store.quota.rejected.disk", counters)
                raise StoreQuotaExceeded(tenant, DISK,
                                         self._tenant_used(tenant, DISK),
                                         self.tenant_quota[DISK])
        entry = StoreEntry(run, tier, self._clock, epoch, app_id, lineage,
                           tenant=tenant)
        key = (path_component, spill_id)
        with self._lock:
            old = self._entries.get(key)
            if old is not None:
                self._unlink_locked(key, old)
            self._entries[key] = entry
            entry.refs += 1
            entry.keys.append(key)
            self._account(entry, +1)
            self._bump("store.published", counters)
            if replica:
                self._bump("store.replica.bytes", counters,
                           int(run.nbytes))
            self._publish_gauges()
        _flight.record(_flight.STORE,
                       "publish.replica" if replica else f"publish.{tier}",
                       tenant, a=int(run.nbytes), b=spill_id)
        with metrics.timer("store.publish"):
            self._enforce_watermarks(counters)

    # -- per-tenant quota helpers --------------------------------------------

    def _tenant_used(self, tenant: str, tier: str) -> int:
        with self._lock:
            return self._tenant_bytes.get(tenant, {}).get(tier, 0)

    def _tenant_over(self, tenant: str, tier: str, nbytes: int) -> bool:
        quota = self.tenant_quota.get(tier, 0)
        if quota <= 0:
            return False
        return self._tenant_used(tenant, tier) + nbytes > quota

    def _evict_tenant_lineage(self, tenant: str, need: int,
                              counters: Any) -> None:
        """Drop the tenant's stalest sealed-lineage disk entries until
        ~need bytes of its disk quota are free (never touches live DAG
        output or other tenants)."""
        with self._lock:
            cands = [(k, e) for k, e in self._entries.items()
                     if e.tier == DISK and e.tenant == tenant
                     and e.leases == 0 and not e.dead
                     and all(kk[0].startswith(LINEAGE_PREFIX)
                             for kk in e.keys)]
            cands.sort(key=lambda ke: ke[1].last_access)
            freed, seen = 0, set()
            for _, entry in cands:
                if freed >= need:
                    break
                if id(entry) in seen:
                    continue
                seen.add(id(entry))
                # sized before the unlink disposes of the run (tez_tpu
                # reads entry.run after it and raises AttributeError)
                size = int(entry.run.nbytes)
                freed += size
                for k in list(entry.keys):
                    self._unlink_locked(k, entry)
                self._bump("store.evictions.disk", counters)
                _flight.record(_flight.STORE, "evict.disk", tenant, a=size)
            self._publish_gauges()

    @staticmethod
    def _drop_lanes(run: Run) -> Run:
        # only the store's reference goes: a merge that reads these lanes
        # on its own stream recorded that stream on them first (module
        # docstring), so the allocator keeps their blocks until it is done
        b = run.batch
        return Run(KVBatch(b.key_bytes, b.key_offsets, b.val_bytes,
                           b.val_offsets, None, b.pre_combined),
                   run.row_index)

    # -- consumer side -------------------------------------------------------

    @contextmanager
    def lease(self, path_component: str, spill_id: int,
              counters: Any = None) -> Iterator[Any]:
        """Pin (path_component, spill_id) for the duration of the block
        and yield its run.  A leased entry is never demoted or evicted,
        so numpy views sliced from it — and a DISK entry's backing file —
        stay valid until release."""
        key = (path_component, spill_id)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry.dead:
                self._bump("store.misses", counters)
                raise StoreKeyNotFound(f"{path_component}/{spill_id}")
            entry.leases += 1
            entry.last_access = self._clock()
            self._bump("store.hits", counters)
            run = entry.run
        try:
            yield run
        finally:
            with self._lock:
                entry.leases -= 1
                if entry.dead and entry.leases == 0 and entry.refs == 0:
                    self._dispose_locked(entry)

    def fetch_partition(self, path_component: str, spill_id: int,
                        partition: int, counters: Any = None) -> KVBatch:
        """One partition as a zero-copy view (HOST/DEVICE tiers) or a
        block-streamed materialization (DISK tier), under a lease."""
        with metrics.timer("store.fetch"):
            with self.lease(path_component, spill_id, counters) as run:
                return run.partition(partition)

    def get(self, path_component: str, spill_id: int) -> Optional[Any]:
        """Unleased peek at the stored run (registry-compat accessor);
        callers that slice it should prefer ``lease``/``fetch_partition``."""
        with self._lock:
            entry = self._entries.get((path_component, spill_id))
            if entry is None or entry.dead:
                return None
            entry.last_access = self._clock()
            return entry.run

    def contains(self, path_component: str, spill_id: int) -> bool:
        with self._lock:
            e = self._entries.get((path_component, spill_id))
            return e is not None and not e.dead

    def spills_for(self, path_component: str) -> List[int]:
        with self._lock:
            return sorted(s for (p, s), e in self._entries.items()
                          if p == path_component and not e.dead)

    # -- deletion ------------------------------------------------------------

    def _unlink_locked(self, key: Tuple[str, int],
                       entry: StoreEntry) -> None:
        self._entries.pop(key, None)
        if key in entry.keys:
            entry.keys.remove(key)
        entry.refs -= 1
        if entry.refs <= 0:
            entry.dead = True
            self._account(entry, -1)
            if entry.leases == 0:
                self._dispose_locked(entry)

    def _dispose_locked(self, entry: StoreEntry) -> None:
        deleter = getattr(entry.run, "delete", None)
        if deleter is not None:
            deleter()
        entry.run = None

    def unregister_prefix(self, prefix: str) -> int:
        """Drop every alias whose path starts with prefix.  Entries whose
        last alias goes — and that hold no lease — free immediately;
        leased ones free at lease release (the reader keeps its views)."""
        with self._lock:
            victims = [(k, e) for k, e in self._entries.items()
                       if k[0].startswith(prefix)]
            for key, entry in victims:
                self._unlink_locked(key, entry)
            self._publish_gauges()
        return len(victims)

    # -- eviction / demotion -------------------------------------------------

    def _over(self, tier: str, capacity: int, mark: float) -> bool:
        return capacity > 0 and self._bytes[tier] > capacity * mark

    def _lru_candidates(self, tier: str) -> List[Tuple[Tuple[str, int],
                                                       StoreEntry]]:
        cands = [(k, e) for k, e in self._entries.items()
                 if e.tier == tier and e.leases == 0 and not e.dead]
        cands.sort(key=lambda ke: ke[1].last_access)
        return cands

    def _enforce_watermarks(self, counters: Any = None) -> None:
        """Cascade demotions until every tier is under its low watermark
        (or only leased entries remain).  DEVICE -> HOST drops the lanes;
        HOST -> DISK spills to a .prun file; DISK evicts only sealed
        lineage entries."""
        while True:
            with self._lock:
                if self._over(DEVICE, self.device_capacity, self.high):
                    self._demote_device_locked(counters,
                                               self.device_capacity * self.low)
                if not self._over(HOST, self.host_capacity, self.high):
                    break
                victim = None
                for key, e in self._lru_candidates(HOST):
                    victim = (key, e)
                    break
                if victim is None:
                    break
                key, entry = victim
                entry.leases += 1          # claim: no concurrent demote
            self._demote_host_entry(key, entry, counters)
        with self._lock:
            if self._over(DISK, self.disk_capacity, self.high):
                self._evict_disk_locked(counters)
            self._publish_gauges()

    def _demote_device_locked(self, counters: Any, target: float) -> None:
        for key, entry in self._lru_candidates(DEVICE):
            if self._bytes[DEVICE] <= target:
                break
            self._account(entry, -1)
            entry.run = self._drop_lanes(entry.run)
            entry.tier = HOST
            entry.dev_nbytes = 0
            self._account(entry, +1)
            self._bump("store.demotions.device_to_host", counters)
            self._bump("store.evictions.device", counters)
            _flight.record(_flight.STORE, "demote.device_to_host",
                           entry.tenant, a=int(entry.run.nbytes))

    def _demote_host_entry(self, key: Tuple[str, int], entry: StoreEntry,
                           counters: Any) -> None:
        """Spill one claimed HOST entry to the disk tier (IO outside the
        registry lock; the synthetic lease keeps eviction away)."""
        path = os.path.join(self.disk_dir,
                            f"demoted_{uuid.uuid4().hex}.prun")
        try:
            os.makedirs(self.disk_dir, exist_ok=True)
            with metrics.timer("store.demote"):
                save_run_partitioned(entry.run, path)
            frun = FileRun(path)
        except (OSError, IOError):
            with self._lock:
                entry.leases -= 1
            return
        with self._lock:
            entry.leases -= 1
            if entry.dead or entry.leases > 0:
                # deleted — or re-leased — while we wrote; keep it in RAM
                # (a reader may hold views) and drop the orphan file
                try:
                    os.remove(path)
                except OSError:
                    pass
                return
            self._account(entry, -1)
            entry.run = frun
            entry.tier = DISK
            entry.host_nbytes = 0
            entry.dev_nbytes = 0
            self._account(entry, +1)
            self._bump("store.demotions.host_to_disk", counters)
            self._bump("store.evictions.host", counters)
        _flight.record(_flight.STORE, "demote.host_to_disk", entry.tenant,
                       a=int(frun.nbytes))

    def _evict_disk_locked(self, counters: Any) -> None:
        target = self.disk_capacity * self.low
        for key, entry in self._lru_candidates(DISK):
            if self._bytes[DISK] <= target:
                break
            if not all(k[0].startswith(LINEAGE_PREFIX) for k in entry.keys):
                continue            # live DAG output: never dropped
            for k in list(entry.keys):
                self._unlink_locked(k, entry)
            self._bump("store.evictions.disk", counters)
            _flight.record(_flight.STORE, "evict.disk", entry.tenant)

    def relieve_device_pressure(self, nbytes: int,
                                counters: Any = None) -> int:
        """Evict-then-split hook for the out-of-memory ladder
        (ops/async_stage.py relieve_pressure): demote LRU unleased DEVICE
        entries until ~nbytes of device lane bytes are freed (or none
        remain).  Returns bytes freed.  The store drops its references
        before it returns, so lanes nobody else holds are back in the
        allocator (``torch.cuda.memory_allocated`` falls) before the
        ladder retries the span."""
        with self._lock:
            before = self._bytes[DEVICE]
            self._demote_device_locked(
                counters, max(0, before - max(0, int(nbytes))))
            freed = before - self._bytes[DEVICE]
            self._publish_gauges()
        return freed

    def relieve_host_pressure(self, nbytes: int,
                              counters: Any = None) -> int:
        """Demote LRU unleased HOST entries to disk until ~nbytes of host
        RAM is freed.  Returns bytes freed."""
        freed = 0
        while freed < nbytes:
            with self._lock:
                victim = None
                for key, e in self._lru_candidates(HOST):
                    victim = (key, e)
                    break
                if victim is None:
                    break
                key, entry = victim
                size = entry.host_nbytes
                entry.leases += 1
            self._demote_host_entry(key, entry, counters)
            with self._lock:
                moved = entry.tier == DISK
            if not moved:
                break
            freed += size
        return freed

    # -- session-mode lineage ------------------------------------------------

    def seal_lineage(self, path_prefix: str, counters: Any = None) -> int:
        """Alias every committed entry under ``path_prefix`` that carries a
        lineage tag to a retained ``__lineage__/<tag>`` key.  Called by the
        AM when the owning DAG commits SUCCEEDED — BEFORE unregister_prefix
        drops the DAG aliases — so identical recurring DAGs can hit.

        This is the governed result cache's admission gate: policy
        'never' seals nothing, 'second-use' only seals lineage tags a
        probe already missed on (scan resistance), and a per-tenant byte
        cap evicts the tenant's least-recently-hit sealed entries to make
        room."""
        if self.result_cache_admit == "never":
            return 0
        sealed = 0
        with self._lock:
            now = self._clock()
            for (path, spill), entry in list(self._entries.items()):
                if not path.startswith(path_prefix) or not entry.lineage \
                        or entry.dead:
                    continue
                if self.result_cache_admit == "second-use" and \
                        entry.lineage not in self._lineage_seen:
                    self._bump("store.result_cache.deferred", counters)
                    continue
                lkey = (LINEAGE_PREFIX + entry.lineage, spill)
                if lkey in self._entries:
                    continue
                self._cap_result_cache_locked(entry.tenant,
                                              self._entry_nbytes(entry),
                                              counters)
                self._entries[lkey] = entry
                entry.refs += 1
                entry.keys.append(lkey)
                entry.sealed_at = now
                sealed += 1
            if sealed:
                self._bump("store.lineage.sealed", counters, sealed)
            self._publish_gauges()
        return sealed

    @staticmethod
    def _entry_nbytes(entry: StoreEntry) -> int:
        return int(getattr(entry.run, "nbytes", 0))

    def _sealed_entries_locked(self, tenant: Optional[str] = None
                               ) -> List[StoreEntry]:
        out, seen = [], set()
        for (p, _), e in self._entries.items():
            if not p.startswith(LINEAGE_PREFIX) or e.dead:
                continue
            if tenant is not None and e.tenant != tenant:
                continue
            if id(e) in seen:
                continue
            seen.add(id(e))
            out.append(e)
        return out

    def _cap_result_cache_locked(self, tenant: str, incoming: int,
                                 counters: Any) -> None:
        """Evict the tenant's least-recently-hit sealed entries until the
        incoming seal fits under the per-tenant result-cache byte cap."""
        if self.result_cache_bytes <= 0:
            return
        sealed = self._sealed_entries_locked(tenant)
        used = sum(self._entry_nbytes(e) for e in sealed)
        if used + incoming <= self.result_cache_bytes:
            return
        sealed.sort(key=lambda e: e.last_access)
        for entry in sealed:
            if used + incoming <= self.result_cache_bytes or \
                    entry.leases > 0:
                break
            used -= self._entry_nbytes(entry)
            # drop ONLY the lineage aliases: a still-live DAG key keeps
            # the entry; a cache-only entry frees entirely
            for k in [k for k in list(entry.keys)
                      if k[0].startswith(LINEAGE_PREFIX)]:
                self._unlink_locked(k, entry)
            self._bump("store.result_cache.evicted", counters)

    def _expire_result_cache_locked(self, counters: Any = None) -> None:
        """Reap sealed entries past the TTL (expired results must not be
        served to a recurring tenant)."""
        if self.result_cache_ttl <= 0:
            return
        cutoff = self._clock() - self.result_cache_ttl
        for entry in self._sealed_entries_locked():
            if entry.sealed_at and entry.sealed_at < cutoff and \
                    entry.leases == 0:
                for k in [k for k in list(entry.keys)
                          if k[0].startswith(LINEAGE_PREFIX)]:
                    self._unlink_locked(k, entry)
                self._bump("store.result_cache.expired", counters)

    def lineage_spills(self, lineage: str, app_id: str = "") -> List[int]:
        """Spill ids sealed under ``lineage``, or [] on a miss.  An entry
        sealed by a superseded AM epoch — or one past the result-cache
        TTL — is fenced out of reuse.  A miss records the tag so the
        'second-use' admission policy seals it next time."""
        path = LINEAGE_PREFIX + lineage
        with self._lock:
            self._expire_result_cache_locked()
            out = []
            for (p, s), e in self._entries.items():
                if p != path or e.dead:
                    continue
                if e.epoch > 0 and epoch_registry.is_stale(e.app_id, e.epoch):
                    continue
                out.append(s)
            name = "store.lineage.hits" if out else "store.lineage.misses"
            if not out:
                self._lineage_seen[lineage] = self._clock()
            self._bump(name)
            return sorted(out)

    def republish_lineage(self, lineage: str, new_path: str,
                          epoch: int = 0, app_id: str = "",
                          counters: Any = None, window_id: int = 0,
                          stream: str = "") -> List[int]:
        """Serve a lineage hit: alias the sealed runs under ``new_path``
        (zero copy — same entries, one more ref each) so the recurring
        DAG's consumers fetch them exactly like fresh output.  Returns the
        aliased spill ids ([] on miss)."""
        if epoch > 0 and epoch_registry.is_stale(app_id, epoch):
            raise EpochFencedError(
                f"lineage republish from stale epoch {epoch}: {lineage}")
        if epoch_registry.is_stale_window(app_id, stream, window_id):
            raise WindowFencedError(
                f"lineage republish from stale window {window_id} of "
                f"stream {stream}: {lineage}")
        path = LINEAGE_PREFIX + lineage
        with self._lock:
            hits = [((p, s), e) for (p, s), e in self._entries.items()
                    if p == path and not e.dead]
            out = []
            for (_, spill), entry in hits:
                nkey = (new_path, spill)
                if nkey in self._entries:
                    self._unlink_locked(nkey, self._entries[nkey])
                self._entries[nkey] = entry
                entry.refs += 1
                entry.keys.append(nkey)
                entry.last_access = self._clock()
                out.append(spill)
            if out:
                self._bump("store.hits", counters, len(out))
            self._publish_gauges()
        return sorted(out)

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"entries": len(self._entries),
                    "bytes": dict(self._bytes),
                    "tenant_bytes": {t: dict(tb) for t, tb
                                     in self._tenant_bytes.items()},
                    "counters": dict(self.counters)}

    def tier_bytes(self, tier: str) -> int:
        with self._lock:
            return self._bytes[tier]

    def capacity(self, tier: str) -> int:
        """Configured byte capacity of a tier (0 = uncapped/disabled);
        the admission controller's store-pressure gate reads this."""
        return {DEVICE: self.device_capacity, HOST: self.host_capacity,
                DISK: self.disk_capacity}[tier]

    def tenant_bytes(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant per-tier resident bytes snapshot (chaos's
        cross-tenant leak check and the /queue endpoint read this)."""
        with self._lock:
            return {t: dict(tb) for t, tb in self._tenant_bytes.items()
                    if any(tb.values())}

    def close(self) -> None:
        """Drop everything (tests / process teardown)."""
        with self._lock:
            entries = set()
            for key, e in list(self._entries.items()):
                entries.add(e)
            self._entries.clear()
            for e in entries:
                e.refs = 0
                e.dead = True
                if e.leases == 0:
                    self._dispose_locked(e)
            self._bytes = {DEVICE: 0, HOST: 0, DISK: 0}
            for tb in self._tenant_bytes.values():
                tb.update({DEVICE: 0, HOST: 0, DISK: 0})
            self._publish_gauges()
        if self._own_dir:
            import shutil
            shutil.rmtree(self.disk_dir, ignore_errors=True)


def telemetry_collector() -> Dict[str, float]:
    """Live-telemetry hook (obs/timeseries registry): tier/tenant resident
    bytes as gauges on every sampler tick.  ``_publish_gauges`` only runs
    on mutation, so a quiescent store's gauges would otherwise go stale in
    the ring — the collector re-reads them under the store lock.  Returns
    ``{}`` when no store is installed (batch mode)."""
    from tez_tpu_torch.store import local_buffer_store
    store = local_buffer_store()
    if store is None:
        return {}
    s = store.stats()
    out: Dict[str, float] = {
        f"store.{tier}.bytes": float(b) for tier, b in s["bytes"].items()}
    out["store.entries"] = float(s["entries"])
    for tenant, tb in s["tenant_bytes"].items():
        out[f"store.tenant.{tenant or 'default'}.bytes"] = \
            float(sum(tb.values()))
    return out
