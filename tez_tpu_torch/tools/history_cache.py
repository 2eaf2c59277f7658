"""Cached read path over history logs — the timeline-cache plugin analog.

Reference role: tez-yarn-timeline-cache-plugin (ATS v1.5 entity-group
cache): the timeline reader groups every entity belonging to one DAG into a
per-DAG group so repeated reads of a finished DAG hit a cache instead of
re-scanning the store.  Here the store is a directory of JSONL history
files (JsonlHistoryLoggingService output); the cache tracks each file's
(mtime, size) fingerprint, re-parses only changed files, keeps per-DAG
DagInfo objects (the "entity group"), and LRU-evicts beyond a cap.

Used by the analyzer CLI (`tez-analyzer --cache-dir`) and embeddable in a
long-lived history-serving process the way the plugin serves the Tez UI.

The port's copy of tez_tpu.tools.history_cache.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from tez_tpu_torch.tools.history_parser import DagInfo, parse_jsonl_files


class DagInfoCache:
    """Entity-group cache over a history log directory."""

    def __init__(self, log_dir: str, max_dags: int = 64):
        self.log_dir = log_dir
        self.max_dags = max_dags
        self._lock = threading.Lock()
        self._fingerprints: Dict[str, Tuple[float, int]] = {}
        # dag_id -> (DagInfo, source files); OrderedDict = LRU order
        self._dags: "OrderedDict[str, DagInfo]" = OrderedDict()
        self._dag_files: Dict[str, frozenset] = {}
        # negative cache: dag_id -> store generation at which the bypass
        # parse proved it absent (repeated lookups of a bogus id must not
        # re-read the whole directory every call)
        self._absent: Dict[str, int] = {}
        self._generation = 0
        self.hits = 0
        self.misses = 0

    # -- store scanning -----------------------------------------------------
    def _scan(self) -> List[str]:
        """Manifest scan over the date-partitioned store (flat legacy
        files included)."""
        from tez_tpu_torch.am.history import scan_history_store
        return scan_history_store(self.log_dir)

    def _changed_files(self) -> List[str]:
        """Changed paths with their NEW fingerprints — which are committed
        only after a successful parse (refresh rolls back on error), so a
        partially-flushed JSONL line from a live AM is retried next call."""
        changed = []
        for path in self._scan():
            try:
                st = os.stat(path)
            except OSError:
                continue
            fp = (st.st_mtime, st.st_size)
            if self._fingerprints.get(path) != fp:
                changed.append((path, fp))
        return changed

    def refresh(self) -> int:
        """Re-parse changed files; returns how many files were re-read.
        A DAG whose events span several files is rebuilt from ALL its known
        source files so partial re-parses cannot truncate it."""
        with self._lock:
            changed = self._changed_files()
            if not changed:
                return 0
            self._generation += 1
            self._absent.clear()
            # re-parse the union of changed files and any file sets of DAGs
            # they touch (cheap: JSONL parse is line-local)
            to_read = set(p for p, _ in changed)
            parsed = parse_jsonl_files(sorted(to_read))
            for dag_id, info in parsed.items():
                known = self._dag_files.get(dag_id, frozenset())
                files = frozenset(to_read) | known
                if known - to_read:
                    # events for this DAG live in unchanged files too —
                    # rebuild from the full set for a complete DagInfo
                    info = parse_jsonl_files(sorted(files)).get(dag_id, info)
                self._dag_files[dag_id] = files
                self._dags[dag_id] = info
                self._dags.move_to_end(dag_id)
            while len(self._dags) > self.max_dags:
                old_id, _ = self._dags.popitem(last=False)
                self._dag_files.pop(old_id, None)
            # commit fingerprints only after every parse returned.  Note the
            # parser tolerates torn lines (it skips unparseable lines rather
            # than raising), so the usual retry path for a half-flushed file
            # is the file's size changing when the AM finishes the line; the
            # deferred commit additionally guarantees that an unexpected
            # parse exception (I/O error, bug) leaves the old fingerprints
            # in place so the next refresh() retries the same files.
            for path, fp in changed:
                self._fingerprints[path] = fp
            return len(changed)

    # -- read API -----------------------------------------------------------
    def get(self, dag_id: str) -> Optional[DagInfo]:
        self.refresh()
        with self._lock:
            info = self._dags.get(dag_id)
            if info is not None:
                self.hits += 1
                self._dags.move_to_end(dag_id)
                return info
            self.misses += 1
            if self._absent.get(dag_id) == self._generation:
                return None   # already proven absent at this store state
        # miss for a possibly LRU-evicted DAG: the files are unchanged so
        # refresh() won't re-read them — do a full bypass parse and
        # re-admit the entry if it exists on disk
        parsed = parse_jsonl_files(self._scan())
        info = parsed.get(dag_id)
        if info is None:
            with self._lock:
                if len(self._absent) >= 4 * self.max_dags:
                    self._absent.pop(next(iter(self._absent)))
                self._absent[dag_id] = self._generation
        if info is not None:
            with self._lock:
                self._dags[dag_id] = info
                self._dag_files[dag_id] = frozenset(self._scan())
                self._dags.move_to_end(dag_id)
                while len(self._dags) > self.max_dags:
                    old_id, _ = self._dags.popitem(last=False)
                    self._dag_files.pop(old_id, None)
        return info

    def dag_ids(self) -> List[str]:
        self.refresh()
        with self._lock:
            return list(self._dags)

    def all(self) -> Dict[str, DagInfo]:
        self.refresh()
        with self._lock:
            return dict(self._dags)
