"""QuerySession: run logical plans through one resident TezClient.

The session is where the adaptive loop closes (docs/query.md):

1. plan — lower the logical plan with the session's PlanFeedback; any
   feedback decision that *changes* a physical choice is journaled as a
   typed ``QUERY_REPLANNED`` summary event BEFORE the DAG submits.
2. run — submit, wait; the session snapshots the process metrics
   registry around the run and attributes the wall to a dominant plane
   with the doctor's prefix->plane map (query/feedback.py).
3. observe — aggregate the qstats side channel (per-task exchange
   records/bytes/partition histograms) and the store's lineage
   cache-hit delta; journal one ``QUERY_SUBMITTED`` record; feed it all
   into PlanFeedback for the next plan of the same fingerprints.

Because vertex names/payloads are content-addressed from the logical
fingerprints, identical subplans across queries in one session hit the
sealed-lineage store (and the governed result cache riding on it) with
no query-layer bookkeeping at all.

The port's copy of tez_tpu.query.session: ``QuerySession(name, conf,
device="cuda")`` hands its device to ``TezClient.create``, so every
query's tasks run there (the card unless the caller passes "cpu").
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from tez_tpu_torch.am.history import HistoryEvent, HistoryEventType
from tez_tpu_torch.client.tez_client import TezClient
from tez_tpu_torch.common import config as C
from tez_tpu_torch.common.metrics import registry as metrics_registry
from tez_tpu_torch.query.feedback import (PlanFeedback,
                                          blame_from_histograms)
from tez_tpu_torch.query.logical import Table
from tez_tpu_torch.query.planner import PlannedQuery, plan_query


@dataclasses.dataclass
class QueryResult:
    state: str
    dag_id: str
    query: str
    fingerprint: str
    output_path: str
    wall_s: float
    blamed: str
    decisions: List[Dict[str, Any]]
    #: QUERY_REPLANNED data dicts journaled for this run
    replans: List[Dict[str, Any]]
    cache_hits: int

    def read_output(self) -> List[Tuple[str, str]]:
        return read_query_output(self.output_path)


def read_query_output(out_dir: str) -> List[Tuple[str, str]]:
    """Sorted (key, value) records from a FileOutput directory — the
    canonical shape the numpy oracle compares against."""
    records: List[Tuple[str, str]] = []
    for part in sorted(glob.glob(os.path.join(out_dir, "part-*"))):
        with open(part, "rb") as f:
            for line in f.read().splitlines():
                if not line:
                    continue
                k, _sep, v = line.partition(b"\t")
                records.append((k.decode("utf-8"), v.decode("utf-8")))
    return sorted(records)


class QuerySession:
    """Resident query session over a (possibly shared) TezClient."""

    def __init__(self, name: str = "query", conf: Optional[Dict] = None,
                 client: Optional[TezClient] = None, device: Any = "cuda"):
        self._owns_client = client is None
        if client is None:
            client = TezClient.create(name, dict(conf or {}), session=True,
                                      device=device).start()
        self.client = client
        self.conf = dict(client.conf)
        if conf:
            self.conf.update(conf)
        self.feedback = PlanFeedback(self.conf)
        self._runs = 0

    # -- lifecycle -----------------------------------------------------

    def close(self) -> None:
        if self._owns_client:
            self.client.stop()

    def __enter__(self) -> "QuerySession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- internals -----------------------------------------------------

    @property
    def _am(self) -> Any:
        return getattr(self.client.framework_client, "am", None)

    def _journal(self, event: HistoryEvent) -> None:
        am = self._am
        if am is not None and hasattr(am, "history"):
            am.history(event)

    def _store_lineage_hits(self) -> int:
        from tez_tpu_torch.store import ensure_store
        store = ensure_store(self.conf)
        if store is None:
            return 0
        try:
            stats = store.stats()
            counters = stats.get("counters", stats)
            return int(counters.get("store.lineage.hits", 0))
        except Exception:
            return 0

    def _stats_dir(self) -> str:
        # one stable dir for the whole session: the stats spec rides in
        # the vertex payload, which the lineage hash covers — a per-run
        # dir would make every vertex unique and defeat the sealed-
        # lineage reuse the content-addressed names exist for.  Files
        # are atomically overwritten per (node, role, vertex, task), so
        # the dir always holds each vertex's latest observed run.
        base = str(self.conf.get(C.QUERY_STATS_DIR.name) or "")
        if not base:
            staging = str(self.conf.get("tez.staging-dir") or "") or None
            if staging is None:
                return ""
            base = os.path.join(staging, "qstats")
        return base

    @staticmethod
    def _collect_qstats(stats_dir: str
                        ) -> Dict[Tuple[str, str], Dict[str, Any]]:
        out: Dict[Tuple[str, str], Dict[str, Any]] = {}
        if not stats_dir or not os.path.isdir(stats_dir):
            return out
        for path in sorted(glob.glob(os.path.join(stats_dir, "*.json"))):
            try:
                with open(path) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            key = (rec["node"], rec["role"])
            agg = out.setdefault(key, {"bytes": 0, "records": 0,
                                       "partitions": []})
            agg["bytes"] += sum(rec.get("partitions", []))
            agg["records"] += rec.get("records", 0)
            parts = rec.get("partitions", [])
            hist = agg["partitions"]
            if len(hist) < len(parts):
                hist.extend([0] * (len(parts) - len(hist)))
            for i, b in enumerate(parts):
                hist[i] += b
        return out

    # -- the adaptive run loop -----------------------------------------

    def plan(self, table: Table, output_path: str,
             query_name: str = "", conf: Optional[Dict] = None,
             sink: Optional[Dict[str, Any]] = None,
             dag_conf: Optional[Dict] = None) -> PlannedQuery:
        merged = dict(self.conf)
        if conf:
            merged.update(conf)
        stats_dir = self._stats_dir()
        return plan_query(table, merged, output_path,
                          dag_name=f"{query_name or 'query'}_"
                                   f"r{self._runs:04d}",
                          feedback=self.feedback, stats_dir=stats_dir,
                          sink=sink, dag_conf=dag_conf)

    def run(self, table: Table, output_path: str, query_name: str = "",
            conf: Optional[Dict] = None,
            sink: Optional[Dict[str, Any]] = None,
            dag_conf: Optional[Dict] = None,
            timeout: float = 180.0) -> QueryResult:
        planned = self.plan(table, output_path, query_name=query_name,
                            conf=conf, sink=sink, dag_conf=dag_conf)
        stats_dir = self._stats_dir()
        self._runs += 1

        # journal every feedback decision that changed a physical choice
        # BEFORE the replanned DAG submits (summary event: must survive
        # an AM crash so doctor can still blame the planner)
        replans: List[Dict[str, Any]] = []
        for d in planned.decisions:
            ex = d.get("extras") or {}
            if d["basis"] == "replan" and ex.get("from") != ex.get("to"):
                data = {"query": query_name or planned.name,
                        "node": d["node"], "operator": d["operator"],
                        "kind": d["kind"], "detail": d["detail"]}
                data.update(ex)
                replans.append(data)
                self._journal(HistoryEvent(
                    HistoryEventType.QUERY_REPLANNED, data=data))

        hits_before = self._store_lineage_hits()
        hist_before = metrics_registry().histograms()
        t0 = time.monotonic()
        dag_client = self.client.submit_dag(planned.dag)
        status = dag_client.wait_for_completion(timeout=timeout)
        wall = time.monotonic() - t0
        hist_after = metrics_registry().histograms()
        blamed, _busy = blame_from_histograms(hist_before, hist_after)
        cache_hits = self._store_lineage_hits() - hits_before

        qstats = self._collect_qstats(stats_dir)
        self.feedback.record_run(planned.decisions, qstats, blamed, wall)

        self._journal(HistoryEvent(
            HistoryEventType.QUERY_SUBMITTED,
            dag_id=str(dag_client.dag_id),
            data={"query": query_name or planned.name,
                  "fingerprint": planned.fingerprint,
                  "strategies": {
                      d["node"]: d["choice"] for d in planned.decisions
                      if d["kind"] == "join_strategy"},
                  "operators": planned.operators,
                  "cache_hits": max(0, cache_hits),
                  "replans": len(replans),
                  "blamed": blamed, "wall_s": round(wall, 4)}))

        return QueryResult(
            state=status.state.name, dag_id=str(dag_client.dag_id),
            query=query_name or planned.name,
            fingerprint=planned.fingerprint, output_path=output_path,
            wall_s=wall, blamed=blamed, decisions=planned.decisions,
            replans=replans, cache_hits=max(0, cache_hits))
