"""Leaf output writing part files with a rename-on-commit committer.

Reference parity: tez-mapreduce MROutput.java:88 + MROutputCommitter (wraps
FileOutputCommitter: write to a temporary attempt dir, commit renames into
the final output dir).

The port's copy of tez_tpu.io.file_output.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, List, Sequence

from tez_tpu_torch.api.events import TezAPIEvent
from tez_tpu_torch.api.initializer import OutputCommitter
from tez_tpu_torch.api.runtime import KeyValueWriter, LogicalOutput, Writer
from tez_tpu_torch.common import epoch as epoch_registry
from tez_tpu_torch.common import faults
from tez_tpu_torch.common.counters import FileSystemCounter, TaskCounter
from tez_tpu_torch.common.epoch import EpochFencedError
from tez_tpu_torch.ops.serde import get_serde

TMP_SUBDIR = "_temporary"
#: Publish journal inside the tmp tree: each part filename is appended (and
#: fsync'd) BEFORE its rename into the output dir, so abort after a partial
#: commit can un-publish exactly the files that made it out.
PUBLISH_MANIFEST = "_publish_manifest"


class _PartWriter(KeyValueWriter):
    def __init__(self, path: str, key_serde: Any, val_serde: Any,
                 context: Any, sep: bytes = b"\t"):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._fh = open(path, "wb")
        self.key_serde = key_serde
        self.val_serde = val_serde
        self.context = context
        self.sep = sep
        # hot path: cache the counter objects once (group+name lookup per
        # record is pure dictionary churn)
        self._records_ctr = context.counters.find_counter(
            TaskCounter.OUTPUT_RECORDS)
        self._bytes_ctr = context.counters.find_counter(
            FileSystemCounter.FILE_BYTES_WRITTEN)

    def write(self, key: Any, value: Any) -> None:
        k = self.key_serde.to_bytes(key)
        v = self.val_serde.to_bytes(value)
        self._fh.write(k + self.sep + v + b"\n")
        self._records_ctr.increment()
        self._bytes_ctr.increment(len(k) + len(self.sep) + len(v) + 1)

    def write_raw(self, data: bytes, n_records: int) -> None:
        """Pre-formatted record bytes (separators/newlines included) from a
        vectorized consumer — one write call for the whole block."""
        self._fh.write(data)
        self._records_ctr.increment(n_records)
        self._bytes_ctr.increment(len(data))

    def close(self) -> None:
        self._fh.close()
        self.context.counters.increment(FileSystemCounter.FILE_WRITE_OPS)


class FileOutput(LogicalOutput):
    """Payload: {"path": output dir, "key_serde": .., "value_serde": ..,
    "separator": "\\t"}.  Writes part-{task:05d} under a temporary attempt
    dir; the committer publishes them."""

    def initialize(self) -> List[TezAPIEvent]:
        payload = self.context.user_payload.load() or {}
        self.out_dir = payload["path"]
        self.key_serde = get_serde(payload.get("key_serde", "text"))
        self.val_serde = get_serde(payload.get("value_serde", "text"))
        self.sep = payload.get("separator", "\t").encode()
        attempt = self.context.task_attempt_id
        self.tmp_path = os.path.join(
            self.out_dir, TMP_SUBDIR, str(attempt),
            f"part-{self.context.task_index:05d}")
        self._writer: _PartWriter | None = None
        return []

    def get_writer(self) -> Writer:
        if self._writer is None:
            self._writer = _PartWriter(self.tmp_path, self.key_serde,
                                       self.val_serde, self.context, self.sep)
        return self._writer

    def handle_events(self, events: Sequence[TezAPIEvent]) -> None:
        pass

    def close(self) -> List[TezAPIEvent]:
        if self._writer is not None:
            self._writer.close()
            # task-level commit: AM arbitration picks exactly one live
            # attempt per task (speculation / retry safety); losers leave
            # their file in the attempt dir, cleaned by the committer
            if self.context.can_commit():
                committed = os.path.join(self.out_dir, TMP_SUBDIR,
                                         "committed",
                                         os.path.basename(self.tmp_path))
                os.makedirs(os.path.dirname(committed), exist_ok=True)
                os.replace(self.tmp_path, committed)
        return []


class FileOutputCommitter(OutputCommitter):
    """Publishes committed part files to the output dir.

    Idempotent and resumable: re-entering commit_output after a crash (the
    recovery roll-forward path) publishes only what is still staged, and a
    crash at any point leaves a state this committer can finish or that
    abort_output can fully roll back.  Every publish is (1) preceded by an
    epoch fence check — a committer owned by a superseded AM incarnation
    must not touch the output — and (2) journaled to the publish manifest
    before the rename, so abort can un-publish a partial commit."""

    def initialize(self) -> None:
        payload = self.context.user_payload.load() or {}
        self.out_dir = payload["path"]

    def setup_output(self) -> None:
        os.makedirs(os.path.join(self.out_dir, TMP_SUBDIR), exist_ok=True)

    def _fence(self, detail: str) -> None:
        app_id = str(getattr(self.context, "app_id", "") or "")
        my_epoch = int(getattr(self.context, "am_epoch", 0) or 0)
        if my_epoch > 0 and epoch_registry.is_stale(app_id, my_epoch):
            faults.fire("fence.stale_epoch", detail=f"commit.publish {detail}")
            raise EpochFencedError(
                f"committer epoch {my_epoch} superseded by "
                f"{epoch_registry.current(app_id)}; refusing to publish "
                f"{detail}")

    def commit_output(self) -> None:
        tmp = os.path.join(self.out_dir, TMP_SUBDIR)
        success = os.path.join(self.out_dir, "_SUCCESS")
        if not os.path.isdir(tmp):
            # tmp tree already gone: a prior incarnation finished publishing
            # and was interrupted at (or after) the _SUCCESS marker — roll
            # forward by (re)writing the marker, nothing else to do
            self._fence("_SUCCESS")
            with open(success, "w"):
                pass
            return
        committed = os.path.join(tmp, "committed")
        if os.path.isdir(committed):
            with open(os.path.join(tmp, PUBLISH_MANIFEST), "a") as mf:
                for f in sorted(os.listdir(committed)):
                    # fault point FIRST (delay mode parks the commit right
                    # here), so a zombie held mid-commit re-checks the fence
                    # when it wakes
                    faults.fire("commit.publish", detail=f)
                    self._fence(f)
                    mf.write(f + "\n")
                    mf.flush()
                    os.fsync(mf.fileno())
                    os.replace(os.path.join(committed, f),
                               os.path.join(self.out_dir, f))
        self._fence("_SUCCESS")
        shutil.rmtree(tmp, ignore_errors=True)
        with open(success, "w"):
            pass

    def abort_output(self, final_state: str) -> None:
        """Roll back a (possibly partial) commit: un-publish every file the
        manifest records, then remove the whole tmp tree.  Idempotent — a
        re-entrant abort (recovery re-runs it after a crash mid-abort) finds
        progressively less to do.  A fully-committed output (tmp gone) is
        left intact: there is nothing staged left to roll back."""
        tmp = os.path.join(self.out_dir, TMP_SUBDIR)
        if not os.path.isdir(tmp):
            return
        manifest = os.path.join(tmp, PUBLISH_MANIFEST)
        if os.path.exists(manifest):
            with open(manifest) as fh:
                for line in fh:
                    name = line.strip()
                    if not name:
                        continue
                    try:
                        os.remove(os.path.join(self.out_dir, name))
                    except FileNotFoundError:
                        pass   # crash between manifest append and rename
        try:
            os.remove(os.path.join(self.out_dir, "_SUCCESS"))
        except FileNotFoundError:
            pass   # a partial commit never reached the marker
        shutil.rmtree(tmp, ignore_errors=True)
