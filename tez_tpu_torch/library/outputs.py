"""Stock outputs: the sorted-shuffle producer side.

Reference parity: tez-runtime-library/.../library/output/
OrderedPartitionedKVOutput.java (sorter selection :151, getWriter :168,
close :189 -> DME events via ShuffleUtils.generateEventOnSpill) — the sorter
behind it is the port's DeviceSorter instead of PipelinedSorter.

The port's copy of tez_tpu.library.outputs.  The sorter runs on the task's
device (the context's).  With the tiered buffer store on
(tez.runtime.store.enabled) runs publish into it, lineage tagged for
cross-DAG output reuse; with push shuffle on
(tez.runtime.shuffle.push.enabled) every spill is also pushed to the
consumer's landing zone while the map wave runs.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Sequence

from tez_tpu_torch.api.events import (CompositeDataMovementEvent,
                                      ShufflePayload, TezAPIEvent,
                                      VertexManagerEvent,
                                      pack_empty_partitions)
from tez_tpu_torch.api.runtime import KeyValuesWriter, LogicalOutput, Writer
from tez_tpu_torch.common import config as C
from tez_tpu_torch.common.counters import TaskCounter
from tez_tpu_torch.library.util import conf_get as _conf_get
from tez_tpu_torch.ops.runformat import Run
from tez_tpu_torch.ops.serde import get_serde
from tez_tpu_torch.ops.sorter import DeviceSorter, sum_long_combiner
from tez_tpu_torch.shuffle.service import local_shuffle_service

log = logging.getLogger(__name__)

_COMBINERS = {"sum_long": sum_long_combiner}

#: the stock partitioner: the sorter hashes on the card, no Python call a
#: record
_HASH_PARTITIONER = "tez_tpu_torch.library.partitioners:HashPartitioner"


def output_path_component(context: Any) -> str:
    # leading DAG id segment enables per-DAG deletion tracking (reference:
    # DeletionTracker / DagDeleteRunnable cleanup of finished DAGs' shuffle
    # data)
    return f"{context.task_attempt_id.dag_id}/{context.task_attempt_id}/" \
           f"{context.destination_vertex_name}"


class _SorterWriter(KeyValuesWriter):
    def __init__(self, sorter: DeviceSorter, key_serde: Any, val_serde: Any,
                 context: Any, partition_fn: Any = None,
                 num_partitions: int = 1):
        self.sorter = sorter
        self.key_serde = key_serde
        self.val_serde = val_serde
        self.context = context
        self.partition_fn = partition_fn
        self.num_partitions = num_partitions
        self._n = 0
        # resolved once: find_counter locks the registry per call
        self._out_bytes_ctr = context.counters.find_counter(
            TaskCounter.OUTPUT_BYTES)

    def write(self, key: Any, value: Any) -> None:
        # a custom Partitioner sees the LOGICAL key/value (pre-serde),
        # matching the reference Partitioner.getPartition contract
        partition = None
        if self.partition_fn is not None:
            partition = int(self.partition_fn(key, value,
                                              self.num_partitions))
        k = self.key_serde.to_bytes(key)
        v = self.val_serde.to_bytes(value)
        self.sorter.write(k, v, partition=partition)
        self._out_bytes_ctr.increment(len(k) + len(v))
        self._n += 1
        if (self._n & 0x3FFF) == 0:
            self.context.notify_progress()   # liveness + kill check

    @property
    def supports_batch(self) -> bool:
        """True when write_batch() will be accepted — batch-first consumers
        probe this BEFORE consuming their reader, so an unsupported config
        (custom Partitioner) falls back to write() instead of failing the
        task mid-stream."""
        return self.partition_fn is None

    def write_batch(self, batch: Any) -> None:
        """Batch-first write path: a KVBatch of PRE-SERIALIZED records goes
        straight to the sorter (no per-record Python).  Only valid with the
        stock hash partitioner — a custom Partitioner sees logical records
        and must use write()."""
        if self.partition_fn is not None:
            raise ValueError("write_batch requires the stock hash "
                             "partitioner (custom Partitioner sees logical "
                             "records)")
        self.sorter.write_batch(batch)
        self.context.counters.increment(TaskCounter.OUTPUT_BYTES,
                                        batch.nbytes)
        self.context.notify_progress()


class OrderedPartitionedKVOutput(LogicalOutput):
    """Sorted, partitioned output feeding OrderedGroupedKVInput."""

    def initialize(self) -> List[TezAPIEvent]:
        ctx = self.context
        sort_mb = int(_conf_get(ctx, "tez.runtime.io.sort.mb", 256))
        self._pipelined = bool(_conf_get(
            ctx, "tez.runtime.pipelined-shuffle.enabled", False))
        # push-based shuffle rides the pipelined spill stream (one eager
        # push per finished spill), so enabling push implies pipelined
        self._push_enabled = bool(_conf_get(
            ctx, "tez.runtime.shuffle.push.enabled", False))
        self._pipelined = self._pipelined or self._push_enabled
        key_width = int(_conf_get(ctx, "tez.runtime.tpu.key.width.bytes", 16))
        combiner_name = _conf_get(ctx, "tez.runtime.combiner.class", "")
        spill_dir = _conf_get(ctx, "tez.runtime.tpu.host.spill.dir", "") or \
            os.path.join(ctx.work_dirs[0], "spill")
        self.key_serde = get_serde(_conf_get(ctx, "tez.runtime.key.class",
                                             "bytes"))
        self.val_serde = get_serde(_conf_get(ctx, "tez.runtime.value.class",
                                             "bytes"))
        engine = _conf_get(ctx, "tez.runtime.sorter.class", "auto")
        merge_factor = int(_conf_get(ctx, "tez.runtime.io.sort.factor", 64))
        sort_threads = int(_conf_get(ctx, "tez.runtime.sort.threads", 0))
        partitioner_cls = _conf_get(ctx, "tez.runtime.partitioner.class",
                                    _HASH_PARTITIONER)
        self.partition_fn = None
        if partitioner_cls != _HASH_PARTITIONER:
            from tez_tpu_torch.common.payload import resolve_class
            self.partition_fn = resolve_class(partitioner_cls)().get_partition
        from tez_tpu_torch.library.comparators import load_comparator
        spill_codec = None
        if _conf_get(ctx, "tez.runtime.compress", False):
            spill_codec = _conf_get(ctx, "tez.runtime.compress.codec", "zlib")
            from tez_tpu_torch.ops.runformat import resolve_codec
            resolve_codec(spill_codec)   # loud error on unknown/unavailable
            # codecs at initialize() — silently-off compression is worse
        self.sorter = DeviceSorter(
            num_partitions=self.num_physical_outputs,
            key_width=key_width,
            span_budget_bytes=sort_mb << 20,
            spill_dir=spill_dir,
            counters=ctx.counters,
            combiner=_COMBINERS.get(combiner_name),
            engine=engine,
            sort_threads=sort_threads,
            merge_factor=merge_factor,
            key_normalizer=load_comparator(ctx),
            spill_codec=spill_codec,
            resident_keys=bool(_conf_get(
                ctx, "tez.runtime.tpu.resident.keys", True)),
            device_min_records=int(_conf_get(
                ctx, "tez.runtime.tpu.device.sort.min.records", 1 << 16)),
            engine_min_bytes=int(_conf_get(
                ctx, "tez.runtime.sort.engine.min-bytes", 1 << 20)),
            # async double-buffered device plane; DeviceSorter keeps it off
            # unless the engine resolves to 'device'.  Spill / pipelined-
            # shuffle emission hooks the completion callback (on_spill runs
            # from the pipeline's readback workers, out of order but with
            # correct spill ids) instead of blocking the collector.
            pipeline_depth=int(_conf_get(
                ctx, "tez.runtime.sort.pipeline.depth", 2)),
            pipeline_coalesce_records=int(_conf_get(
                ctx, "tez.runtime.sort.pipeline.coalesce.records", -1)),
            # failure containment for the async plane: watchdog deadlines,
            # host-engine failover breaker, OOM split floor
            watchdog_dispatch_ms=float(_conf_get(
                ctx, "tez.runtime.device.watchdog.dispatch-ms", 60_000)),
            watchdog_readback_ms=float(_conf_get(
                ctx, "tez.runtime.device.watchdog.readback-ms", 60_000)),
            breaker_failures=int(_conf_get(
                ctx, "tez.runtime.device.breaker.failures", 3)),
            breaker_cooldown_ms=float(_conf_get(
                ctx, "tez.runtime.device.breaker.cooldown-ms", 5_000)),
            split_min_bytes=int(_conf_get(
                ctx, "tez.runtime.device.split.min-bytes", 1 << 20)),
            device=ctx.device,
        )
        ctx.request_initial_memory(sort_mb << 20, None,
                                   component_type="PARTITIONED_SORTED_OUTPUT")
        self._spills_sent = 0
        if self._pipelined:
            self.sorter.on_spill = self._ship_spill
        self.service = local_shuffle_service()
        self.host = ctx.get_service_provider_metadata("shuffle") or \
            {"host": "local", "port": 0}
        # tiered buffer store: runners create their own process store from
        # the task conf (in-process mode finds the AM's); outputs publish
        # with a lineage tag so a later identical DAG can reuse them
        from tez_tpu_torch.store import ensure_store
        merged: Dict[str, Any] = dict(ctx.conf)
        payload = ctx.user_payload.load()
        if isinstance(payload, dict):
            merged.update(payload)
        ensure_store(merged)
        self._lineage = ""
        self._reused = False
        self._reuse_ready = False
        if not self._pipelined and bool(_conf_get(
                ctx, "tez.runtime.store.lineage.reuse", True)):
            from tez_tpu_torch.store.lineage import task_lineage
            self._lineage = task_lineage(
                getattr(ctx, "lineage", ""), ctx.task_index,
                ctx.destination_vertex_name)
        self._pusher = None
        if self._push_enabled:
            from tez_tpu_torch.shuffle.push import SpillPusher
            self._pusher = SpillPusher(
                self.service,
                threads=int(_conf_get(
                    ctx, "tez.runtime.shuffle.push.threads", 2)),
                retries=int(_conf_get(
                    ctx, "tez.runtime.shuffle.push.retries", 3)),
                inflight_limit_bytes=int(float(_conf_get(
                    ctx, "tez.runtime.shuffle.push.inflight-limit-mb",
                    64)) * (1 << 20)),
                counters=ctx.counters,
                epoch=getattr(ctx, "am_epoch", 0),
                app_id=getattr(ctx, "app_id", ""),
                tenant=getattr(ctx, "tenant", ""),
                replicas=int(_conf_get(
                    ctx, "tez.runtime.shuffle.push.replicas", 1)),
                window_id=getattr(ctx, "window_id", 0),
                stream=getattr(ctx, "stream", ""))
        store = self.service.buffer_store()
        if self._lineage and store is not None:
            # a non-pipelined output seals exactly one run (spill -1);
            # anything else means a partial/incompatible seal — recompute
            self._reuse_ready = store.lineage_spills(
                self._lineage, app_id=getattr(ctx, "app_id", "")) == [-1]
        return []

    # -- cross-DAG output reuse (session mode) -------------------------------
    def reuse_available(self) -> bool:
        """True when the store holds this task's sealed output from an
        identical earlier DAG — the runner may then skip the processor and
        publish_reused() instead of recomputing."""
        return self._reuse_ready

    def publish_reused(self) -> List[TezAPIEvent]:
        """Alias the sealed lineage run under this attempt's path (zero
        copy) and emit the same DME/VM events a fresh sort would."""
        store = self.service.buffer_store()
        ctx = self.context
        path = output_path_component(ctx)
        store.republish_lineage(self._lineage, path,
                                epoch=getattr(ctx, "am_epoch", 0),
                                app_id=getattr(ctx, "app_id", ""),
                                counters=ctx.counters,
                                window_id=getattr(ctx, "window_id", 0),
                                stream=getattr(ctx, "stream", ""))
        run = store.get(path, -1)
        ctx.counters.increment(TaskCounter.OUTPUT_BYTES_PHYSICAL, run.nbytes)
        ctx.counters.find_counter("ShuffleStore",
                                  "store.reuse.outputs").increment(1)
        self._reused = True
        return self._events_for_run(run, -1, True)

    def get_writer(self) -> Writer:
        return _SorterWriter(self.sorter, self.key_serde, self.val_serde,
                             self.context, partition_fn=self.partition_fn,
                             num_partitions=self.num_physical_outputs)

    def handle_events(self, events: Sequence[TezAPIEvent]) -> None:
        pass

    # -- event generation (ShuffleUtils.generateEventOnSpill analog) ---------
    def _events_for_run(self, run: Run, spill_id: int,
                        last: bool) -> List[TezAPIEvent]:
        payload = ShufflePayload(
            host=self.host["host"], port=self.host["port"],
            path_component=output_path_component(self.context),
            empty_partitions=pack_empty_partitions(
                run.empty_partition_flags()),
            spill_id=spill_id if self._pipelined else -1,
            last_event=last)
        total = run.nbytes
        vm_payload: Dict[str, Any] = {"output_size": total}
        if _conf_get(self.context, C.REPORT_PARTITION_STATS.name,
                     C.REPORT_PARTITION_STATS.default):
            # per-partition sizes feed auto-parallelism / fair-shuffle;
            # deployments with huge partition counts can turn the detail
            # off and keep only the total (reference knob)
            vm_payload["partition_sizes"] = [
                run.partition_nbytes(p) for p in range(run.num_partitions)]
        return [
            CompositeDataMovementEvent(0, run.num_partitions, payload),
            VertexManagerEvent(
                target_vertex_name=self.context.destination_vertex_name,
                user_payload=vm_payload),
        ]

    def _ship_spill(self, run: Run, spill_id: int) -> None:
        # spill-scale pipelined spans go to disk as partition-indexed files
        # and register disk-backed: RAM stays bounded, same-host consumers
        # merge disk-direct off the span file, and there is NO producer
        # final merge at all (the pipelined point, reference:
        # tez.runtime.pipelined-shuffle.enabled -> one event per spill)
        sorter = self.sorter
        ctr = self.context.counters
        # _store_run convention: every shipped span counts as spilled
        ctr.increment(TaskCounter.SPILLED_RECORDS, run.batch.num_records)
        push = self._pusher is not None
        if sorter.spill_dir is not None and run.nbytes >= (1 << 20) and \
                not self.service.has_store() and \
                not (push and self.service.buffer_store() is not None):
            # (with push + a buffer store, the store's watermark demotion
            # is the bounded disk path and admission is the backpressure —
            # a pspill here would re-serialize every spill for nothing)
            # (with a write-through store attached the store's own file IS
            # the disk copy — writing a pspill too would double the I/O)
            import uuid as _uuid
            from tez_tpu_torch.ops.runformat import (FileRun,
                                                     save_run_partitioned)
            path = os.path.join(sorter.spill_dir,
                                f"pspill_{_uuid.uuid4().hex}.prun")
            save_run_partitioned(run, path, codec=sorter.spill_codec)
            written = os.path.getsize(path)
            ctr.increment(TaskCounter.ADDITIONAL_SPILLS_BYTES_WRITTEN,
                          written)
            ctr.increment(TaskCounter.ADDITIONAL_SPILL_COUNT)
            ctr.increment(TaskCounter.HOST_SPILL_BYTES, written)
            run = FileRun(path)
        path = output_path_component(self.context)
        # push mode: the SYNCHRONOUS bare-registry register below is the
        # pull backstop (events never race a missing key; a dead pusher
        # never loses data) — the async push then aliases the same run
        # into the reducer-side store, zero copy
        self.service.register(path, spill_id,
                              run, epoch=getattr(self.context, "am_epoch", 0),
                              app_id=getattr(self.context, "app_id", ""),
                              lineage=self._lineage,
                              tenant=getattr(self.context, "tenant", ""),
                              counters=self.context.counters,
                              use_store=not push,
                              window_id=getattr(self.context,
                                                "window_id", 0),
                              stream=getattr(self.context, "stream", ""))
        # last=False; close() sends the final marker
        self.context.send_events(self._events_for_run(run, spill_id, False))
        self._spills_sent += 1
        self.context.counters.increment(TaskCounter.SHUFFLE_CHUNK_COUNT)
        if push:
            self._pusher.submit(path, spill_id, run,
                                host=self.host["host"],
                                port=self.host["port"])

    def abort(self) -> None:
        """The attempt was killed: the sorter drops its spans (its pipeline
        gives its streams back) and nothing more is registered or
        pushed."""
        sorter = getattr(self, "sorter", None)
        if sorter is not None:
            sorter.abort()
        if getattr(self, "_pusher", None) is not None:
            self._pusher.close()

    def close(self) -> List[TezAPIEvent]:
        if self._reused:
            # publish_reused() already registered + announced the output;
            # flushing the (empty) sorter would clobber the reused run
            return []
        final_run = self.sorter.flush_run()
        if self._pusher is not None:
            # drain: every queued push lands (or exhausts retries into the
            # pull backstop) before the task reports DONE, so push
            # counters are settled and the final marker is truthful
            self._pusher.close()
        if self._pipelined:
            # final empty marker event with last_event=True for completeness
            payload = ShufflePayload(
                host=self.host["host"], port=self.host["port"],
                path_component=output_path_component(self.context),
                empty_partitions=pack_empty_partitions(
                    [True] * self.num_physical_outputs),
                spill_id=self._spills_sent, last_event=True)
            self.service.register(output_path_component(self.context),
                                  self._spills_sent,
                                  _empty_run(self.num_physical_outputs),
                                  epoch=getattr(self.context, "am_epoch", 0),
                                  app_id=getattr(self.context, "app_id", ""),
                                  counters=self.context.counters,
                                  window_id=getattr(self.context,
                                                    "window_id", 0),
                                  stream=getattr(self.context, "stream", ""))
            return [CompositeDataMovementEvent(0, self.num_physical_outputs,
                                               payload)]
        assert final_run is not None
        self.service.register(output_path_component(self.context), -1,
                              final_run,
                              epoch=getattr(self.context, "am_epoch", 0),
                              app_id=getattr(self.context, "app_id", ""),
                              lineage=self._lineage,
                              tenant=getattr(self.context, "tenant", ""),
                              counters=self.context.counters,
                              window_id=getattr(self.context,
                                                "window_id", 0),
                              stream=getattr(self.context, "stream", ""))
        self.context.counters.increment(
            TaskCounter.OUTPUT_BYTES_PHYSICAL, final_run.nbytes)
        return self._events_for_run(final_run, -1, True)


def _empty_run(num_partitions: int):
    import numpy as np
    from tez_tpu_torch.ops.runformat import KVBatch
    return Run(KVBatch.empty(), np.zeros(num_partitions + 1, dtype=np.int64))
