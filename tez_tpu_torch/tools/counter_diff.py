"""Compare counters — and latency histograms — between two DAG runs.

Reference parity: tez-tools counter-diff.  Usage:
  python -m tez_tpu_torch.tools.counter_diff <history_a.jsonl> <history_b.jsonl>

Plain counters are diffed value-by-value.  ``LatencyHistogram.*`` counter
groups (written by tez_tpu_torch.common.metrics when the tracing/metrics plane is
on) are decoded back into bucket distributions and compared on p50/p95/max,
so a latency regression shows up as "shuffle.fetch.rtt p95 12ms -> 48ms"
rather than an opaque bucket-count delta.

The telemetry section diffs the stop-time ``TELEMETRY_SNAPSHOT`` journal
events: ring-eviction / collector-failure / scrape-error growth is
flagged (an adequately-sized always-on plane has zero of each), series
cardinality and burn-alert counts are reported unflagged.

The port's copy of tez_tpu.tools.counter_diff.
"""
from __future__ import annotations

import sys
from typing import Any, Dict, List, Tuple

from tez_tpu_torch.common.counters import (MESH_EXCHANGE_EFFICIENCY_COUNTERS,
                                           MESH_EXCHANGE_GROUP,
                                           MESH_EXCHANGE_PRESSURE_COUNTERS)
from tez_tpu_torch.common.metrics import HIST_GROUP_PREFIX, histograms_from_counters
from tez_tpu_torch.tools.history_parser import parse_jsonl_files

# p95 ratio above which a histogram line is flagged as a regression; bucket
# resolution is powers-of-2 ms, so anything under 2x is within quantisation.
REGRESSION_RATIO = 2.0

#: The async device plane's stage histograms (ops/async_stage.py), in
#: pipeline order.  Diffed as cumulative wall ms per stage: stage SUMS say
#: where the plane's time moved (p95 alone can hide a stage whose every
#: span got uniformly slower).
DEVICE_STAGE_HISTS = ("device.encode", "device.h2d", "device.dispatch_wait",
                      "device.d2h")

#: The reduce-side merge plane's histograms: ``device.merge`` is device
#: merge-kernel wall (merge-path dispatches plus the async merge lane's
#: dispatch-wait), ``shuffle.merge`` the consumer-side merge/commit wall.
#: Diffed like the device stages — cumulative wall ms — so a reduce side
#: that quietly fell off the merge-path kernel onto concatenate+re-sort
#: (or host failover) shows up as a sum shift even when p95 stays inside
#: one power-of-2 bucket.
MERGE_STAGE_HISTS = ("device.merge", "shuffle.merge")

#: Failure-containment counters (ops/async_stage.py COUNTER_GROUP): a run
#: that silently started leaning on host failover — or tripping the breaker
#: — is a health regression even when wall clock barely moves, so these get
#: their own section instead of drowning in the flat counter diff.
DEVICE_FAILOVER_GROUP = "DeviceFailover"
DEVICE_FAILOVER_COUNTERS = (
    "device.failover.spans", "device.failover.groups",
    "device.failover.drained", "device.watchdog.fires",
    "device.watchdog.dispatch_fires", "device.watchdog.readback_fires",
    "device.breaker.trips", "device.breaker.short_circuits",
    "device.breaker.recoveries", "device.oom.split_attempts",
    "device.oom.split_success")


#: Tiered buffer-store counters (tez_tpu_torch/store COUNTER_GROUP).  Hits and
#: short-circuits are efficiency (more is better — never flagged);
#: evictions/demotions are pressure: growth means the run started churning
#: its tiers, which costs spill I/O even when wall clock barely moves.
STORE_GROUP = "ShuffleStore"
STORE_EFFICIENCY_COUNTERS = (
    "store.published", "store.hits", "store.misses", "store.short_circuit",
    "store.lineage.hits", "store.lineage.misses", "store.lineage.sealed",
    "store.reuse.tasks", "store.reuse.outputs")
STORE_PRESSURE_COUNTERS = (
    "store.demotions.device_to_host", "store.demotions.host_to_disk",
    "store.evictions.device", "store.evictions.host", "store.evictions.disk")


#: Push-based shuffle (tez_tpu_torch/shuffle/push.py).  Pushed bytes are
#: efficiency (eager pushes landing = the pipeline working — never
#: flagged); rejections are pressure: growth means the admission
#: controller (or a dead transport) started turning pushes away and the
#: run leaned back on the pull path.  The counters live in the TaskCounter
#: enum group; the histograms ride the common LatencyHistogram plumbing.
PUSH_GROUP = "TaskCounter"
PUSH_EFFICIENCY_COUNTERS = ("SHUFFLE_PUSH_BYTES",)
PUSH_PRESSURE_COUNTERS = ("SHUFFLE_PUSH_REJECTED",)
PUSH_HISTS = ("shuffle.push.rtt", "shuffle.push.admit_wait")


#: Mesh ICI exchange (parallel/coordinator.py).  Rows/bytes sent and coded
#: duplicate traffic are workload-shaped efficiency numbers (coded
#: duplicate bytes literally buy straggler masking — never flagged);
#: rounds and splits are pressure: growth means the exchange plane started
#: re-rounding or re-partitioning to absorb skew it previously did not
#: see.  Per-round RTT rides the common LatencyHistogram plumbing.
EXCHANGE_GROUP = MESH_EXCHANGE_GROUP
EXCHANGE_EFFICIENCY_COUNTERS = MESH_EXCHANGE_EFFICIENCY_COUNTERS
EXCHANGE_PRESSURE_COUNTERS = MESH_EXCHANGE_PRESSURE_COUNTERS
EXCHANGE_HISTS = ("mesh.exchange.round",)


#: AM crash-survival (am/recovery.py queue replay, task_comm.py epoch
#: fencing, coded push replicas).  Requeued submissions and zombie-fenced
#: attempts come off the session recovery stream; replica traffic off the
#: ShuffleStore group.  A fault-free run has none of the first three, so
#: any growth is flagged; replica BYTES are workload-shaped (replicas=2
#: pays them on purpose, like coded duplicate exchange — never flagged).
RECOVERY_REPLICA_COUNTERS = ("store.replica.bytes", "store.replica.failover")


#: Streaming mode (am/streaming.py).  Committed windows are workload-
#: shaped (more input = more windows — never flagged); replays, aborts,
#: and lag episodes are pressure: a fault-free keeping-up stream has none,
#: so any growth is flagged.  Per-window latency rides the common
#: LatencyHistogram plumbing plus an exact p50/p95 recomputed from the
#: window-commit ledger timestamps.
STREAM_HISTS = ("stream.window.latency", "stream.window.lag")


#: Observability plane (obs/flight.py, am/admission.py).  Queue wait is
#: admission pressure — growth means submissions parked longer before
#: promotion; flight-dump wall is the recorder's own cost, which must
#: stay negligible (a dump storm in B that A never paid shows up here
#: before it shows up anywhere else).
OBS_HISTS = ("am.admit.queue_wait", "obs.flight.dump")


def tenant_summary(dags: Dict) -> Dict[str, Dict]:
    """Per-tenant admission/latency roll-up over a whole session history:
    {tenant: {submitted, completed, failed, queued, shed, p50_s, p95_s}}.
    Latencies are exact per-DAG submit->finish walls sorted and read at the
    quantile rank — NOT the registry's per-tenant dynamic histograms, which
    deliberately stay out of the lint-checked ``*_HISTS`` tuples."""
    out: Dict[str, Dict] = {}

    def row(tenant: str) -> Dict:
        return out.setdefault(tenant or "<anon>", {
            "submitted": 0, "completed": 0, "failed": 0,
            "queued": 0, "shed": 0, "latencies": []})

    admission = []
    for d in dags.values():
        r = row(d.tenant)
        r["submitted"] += 1
        if d.state == "SUCCEEDED":
            r["completed"] += 1
        elif d.state:
            r["failed"] += 1
        if d.finish_time > d.submit_time > 0:
            r["latencies"].append(d.finish_time - d.submit_time)
        admission = d.admission_events or admission
    for ev in admission:
        row(ev["tenant"])["queued" if ev["event"] == "QUEUED"
                          else "shed"] += 1
    for r in out.values():
        lats = sorted(r.pop("latencies"))
        r["p50_s"] = lats[int(0.50 * (len(lats) - 1))] if lats else 0.0
        r["p95_s"] = lats[int(0.95 * (len(lats) - 1))] if lats else 0.0
    return out


def diff_tenants(dags_a: Dict, dags_b: Dict,
                 ) -> List[Tuple[str, Dict, Dict, bool]]:
    """[(tenant, summary_a|{}, summary_b|{}, regressed)] for every tenant
    in either session; regressed when B shed more, failed more, or its p95
    latency crossed REGRESSION_RATIO x A's (shed growth = admission started
    turning this tenant away; submitted/completed deltas are workload)."""
    ta, tb = tenant_summary(dags_a), tenant_summary(dags_b)
    out = []
    for tenant in sorted(set(ta) | set(tb)):
        a, b = ta.get(tenant, {}), tb.get(tenant, {})
        regressed = bool(a and b and (
            b["shed"] > a["shed"] or b["failed"] > a["failed"] or
            (a["p95_s"] > 0 and b["p95_s"] >= REGRESSION_RATIO * a["p95_s"])))
        out.append((tenant, a, b, regressed))
    return out


def recovery_summary(dags: Dict) -> Dict[str, int]:
    """Session recovery roll-up off the recovery stream:
    ``{"requeued": n, "fenced": n}``."""
    events: List[Dict] = []
    for d in dags.values():
        events = d.recovery_events or events
    return {"requeued": sum(1 for e in events if e["event"] == "REQUEUED"),
            "fenced": sum(1 for e in events if e["event"] == "FENCED")}


def diff_recovery(dags_a: Dict, dags_b: Dict,
                  counters_a: Dict, counters_b: Dict,
                  ) -> List[Tuple[str, int, int, bool]]:
    """[(name, a, b, regressed)] for the crash-survival section: requeued
    submissions, zombie-fenced attempts, and replica failovers — any
    growth is flagged (these are zero on a healthy fault-free run);
    replica bytes are reported but never flagged."""
    ra, rb = recovery_summary(dags_a), recovery_summary(dags_b)
    ga = counters_a.get(STORE_GROUP, {})
    gb = counters_b.get(STORE_GROUP, {})
    out = []
    for name, va, vb in (
            ("dags.requeued_on_recovery", ra["requeued"], rb["requeued"]),
            ("attempts.zombie_fenced", ra["fenced"], rb["fenced"])):
        if va or vb:
            out.append((name, va, vb, vb > va))
    for name in RECOVERY_REPLICA_COUNTERS:
        if name not in ga and name not in gb:
            continue
        va, vb = int(ga.get(name, 0)), int(gb.get(name, 0))
        out.append((name, va, vb,
                    name == "store.replica.failover" and vb > va))
    return out


def stream_summary(dags: Dict) -> Dict[str, Any]:
    """Session streaming roll-up off the window-commit ledger stream:
    ``{"committed", "replayed", "aborted", "lag_episodes", "p50_ms",
    "p95_ms"}``.  Per-window latency is exact — COMMIT_FINISHED timestamp
    minus the window DAG's submit time — so it works on histories whose
    metrics plane was off."""
    events: List[Dict] = []
    for d in dags.values():
        events = getattr(d, "stream_events", None) or events
    committed = [e for e in events if e["event"] == "COMMIT_FINISHED"]
    lat: List[float] = []
    for e in committed:
        d = dags.get(e.get("dag_id", ""))
        if d is not None and d.submit_time and e["time"] > d.submit_time:
            lat.append((e["time"] - d.submit_time) * 1000.0)
    lat.sort()
    return {
        "committed": len(committed),
        "replayed": sum(1 for e in committed if e.get("replayed")),
        "aborted": sum(1 for e in events if e["event"] == "COMMIT_ABORTED"),
        "lag_episodes": sum(1 for e in events if e["event"] == "LAGGING"),
        "p50_ms": lat[len(lat) // 2] if lat else 0.0,
        "p95_ms": lat[int(len(lat) * 0.95)] if lat else 0.0,
    }


def telemetry_summary(dags: Dict) -> Dict[str, int]:
    """Session telemetry roll-up off the journaled stop-time
    ``TELEMETRY_SNAPSHOT`` (last one wins — each AM incarnation journals
    its own) plus the burn-alert count: ``{"series", "evicted",
    "collector_errors", "scrape_errors", "burn_alerts"}``."""
    events: List[Dict] = []
    for d in dags.values():
        events = getattr(d, "telemetry_events", None) or events
    snap: Dict = {}
    for e in events:
        if e["event"] == "SNAPSHOT":
            snap = e
    return {
        "series": int(snap.get("series", 0)),
        "evicted": int(snap.get("evicted", 0)),
        "collector_errors": int(snap.get("collector_errors", 0)),
        "scrape_errors": int(snap.get("scrape_errors", 0)),
        "burn_alerts": sum(1 for e in events if e["event"] == "BURN"),
    }


def query_summary(dags: Dict) -> Dict[str, int]:
    """Session query-plane roll-up off the planner's journal stream
    (tez_tpu_torch/query/session.py): ``{"plans", "cache_hits", "replans"}``.
    ``plans`` counts QUERY_SUBMITTED records, ``cache_hits`` sums their
    sealed-lineage result-cache deltas, ``replans`` counts the typed
    QUERY_REPLANNED decisions."""
    events: List[Dict] = []
    for d in dags.values():
        events = getattr(d, "query_events", None) or events
    submitted = [e for e in events if e["event"] == "SUBMITTED"]
    return {
        "plans": len(submitted),
        "cache_hits": sum(int(e.get("cache_hits", 0)) for e in submitted),
        "replans": sum(1 for e in events if e["event"] == "REPLANNED"),
    }


def diff_query(dags_a: Dict, dags_b: Dict
               ) -> List[Tuple[str, int, int, bool]]:
    """[(name, a, b, regressed)] for the query-plane section: plan count
    is workload-shaped and cache hits are efficiency (more is better) —
    both unflagged; replan growth IS flagged: a replan means the static
    planner mis-sized an exchange badly enough to pay a whole observe-
    and-rerun cycle, so more of them against the same workload means the
    estimator (or the feedback loop's stability) regressed."""
    sa, sb = query_summary(dags_a), query_summary(dags_b)
    if not (sa["plans"] or sb["plans"]):
        return []
    return [
        ("query.plans", sa["plans"], sb["plans"], False),
        ("query.result_cache.hits", sa["cache_hits"], sb["cache_hits"],
         False),
        ("query.replans", sa["replans"], sb["replans"],
         sb["replans"] > sa["replans"]),
    ]


def diff_telemetry(dags_a: Dict, dags_b: Dict
                   ) -> List[Tuple[str, int, int, bool]]:
    """[(name, a, b, regressed)] for the telemetry-plane section: ring
    evictions, collector failures, and scrape errors are flagged on any
    growth (a correctly-sized always-on plane has zero of each); series
    cardinality and burn-alert count are reported unflagged (workload-
    shaped — a chaos leg SHOULD page)."""
    sa, sb = telemetry_summary(dags_a), telemetry_summary(dags_b)
    if not any(sa.values()) and not any(sb.values()):
        return []
    return [
        ("telemetry.series", sa["series"], sb["series"], False),
        ("telemetry.ring.evicted", sa["evicted"], sb["evicted"],
         sb["evicted"] > sa["evicted"]),
        ("telemetry.collector.errors", sa["collector_errors"],
         sb["collector_errors"],
         sb["collector_errors"] > sa["collector_errors"]),
        ("telemetry.scrape.errors", sa["scrape_errors"],
         sb["scrape_errors"],
         sb["scrape_errors"] > sa["scrape_errors"]),
        ("telemetry.slo.burn_alerts", sa["burn_alerts"],
         sb["burn_alerts"], False),
    ]


def diff_stream(dags_a: Dict, dags_b: Dict
                ) -> List[Tuple[str, float, float, bool]]:
    """[(name, a, b, regressed)] for the streaming section: committed
    windows and exact p50/p95 are reported unflagged (workload-shaped);
    replay, abort, and lag-episode growth is flagged — a keeping-up
    fault-free stream has zero of each."""
    sa, sb = stream_summary(dags_a), stream_summary(dags_b)
    if not (sa["committed"] or sb["committed"] or sa["aborted"]
            or sb["aborted"]):
        return []
    out: List[Tuple[str, float, float, bool]] = [
        ("stream.windows.committed", sa["committed"], sb["committed"],
         False),
        ("stream.windows.replayed", sa["replayed"], sb["replayed"],
         sb["replayed"] > sa["replayed"]),
        ("stream.windows.aborted", sa["aborted"], sb["aborted"],
         sb["aborted"] > sa["aborted"]),
        ("stream.lag.episodes", sa["lag_episodes"], sb["lag_episodes"],
         sb["lag_episodes"] > sa["lag_episodes"]),
        ("stream.window.p50_ms", round(sa["p50_ms"], 1),
         round(sb["p50_ms"], 1), False),
        ("stream.window.p95_ms", round(sa["p95_ms"], 1),
         round(sb["p95_ms"], 1), False),
    ]
    return out


def diff_exchange(counters_a: Dict, counters_b: Dict,
                  ) -> List[Tuple[str, int, int, bool]]:
    """[(counter, a, b, regressed)] over the mesh-exchange section;
    regressed only when B needed more rounds or splits than A (row/byte
    and coded-duplicate deltas are workload-shaped, not regressions)."""
    ga = counters_a.get(EXCHANGE_GROUP, {})
    gb = counters_b.get(EXCHANGE_GROUP, {})
    out = []
    for name in EXCHANGE_EFFICIENCY_COUNTERS + EXCHANGE_PRESSURE_COUNTERS:
        if name not in ga and name not in gb:
            continue
        va, vb = int(ga.get(name, 0)), int(gb.get(name, 0))
        out.append((name, va, vb,
                    name in EXCHANGE_PRESSURE_COUNTERS and vb > va))
    return out


def diff_push(counters_a: Dict, counters_b: Dict,
              ) -> List[Tuple[str, int, int, bool]]:
    """[(counter, a, b, regressed)] over the push-shuffle section;
    regressed only when B rejected more pushes than A (pushed-byte deltas
    are workload-shaped, not regressions)."""
    ga = counters_a.get(PUSH_GROUP, {})
    gb = counters_b.get(PUSH_GROUP, {})
    out = []
    for name in PUSH_EFFICIENCY_COUNTERS + PUSH_PRESSURE_COUNTERS:
        if name not in ga and name not in gb:
            continue
        va, vb = int(ga.get(name, 0)), int(gb.get(name, 0))
        out.append((name, va, vb,
                    name in PUSH_PRESSURE_COUNTERS and vb > va))
    return out


def diff_store(counters_a: Dict, counters_b: Dict,
               ) -> List[Tuple[str, int, int, bool]]:
    """[(counter, a, b, regressed)] over the buffer-store section;
    regressed only for PRESSURE counters where B churned more than A
    (eviction/demotion growth = the store started thrashing — hit/miss
    deltas are workload-shaped, not regressions)."""
    ga = counters_a.get(STORE_GROUP, {})
    gb = counters_b.get(STORE_GROUP, {})
    out = []
    for name in STORE_EFFICIENCY_COUNTERS + STORE_PRESSURE_COUNTERS:
        if name not in ga and name not in gb:
            continue
        va, vb = int(ga.get(name, 0)), int(gb.get(name, 0))
        out.append((name, va, vb,
                    name in STORE_PRESSURE_COUNTERS and vb > va))
    return out


def flatten(counters: Dict) -> Dict[str, int]:
    return {f"{g}.{name}": v for g, cs in counters.items()
            if not g.startswith(HIST_GROUP_PREFIX)
            for name, v in cs.items()}


def diff_histograms(counters_a: Dict, counters_b: Dict,
                    ) -> List[Tuple[str, Dict, Dict, bool]]:
    """[(name, summary_a|{}, summary_b|{}, regressed)] for every histogram
    present in either run; regressed means B's p95 is REGRESSION_RATIO x
    A's (only meaningful when both runs recorded the histogram)."""
    ha = histograms_from_counters(counters_a)
    hb = histograms_from_counters(counters_b)
    out = []
    for name in sorted(set(ha) | set(hb)):
        a, b = ha.get(name, {}), hb.get(name, {})
        regressed = bool(
            a and b and a["p95"] > 0 and b["p95"] >= REGRESSION_RATIO * a["p95"])
        out.append((name, a, b, regressed))
    return out


def diff_device_stages(counters_a: Dict, counters_b: Dict,
                       names: Tuple[str, ...] = DEVICE_STAGE_HISTS,
                       ) -> List[Tuple[str, float, float, bool]]:
    """[(stage, sum_ms_a, sum_ms_b, regressed)] for the named stage
    histograms present in either run; regressed when B spent
    REGRESSION_RATIO x A's total wall in that stage."""
    ha = histograms_from_counters(counters_a)
    hb = histograms_from_counters(counters_b)
    out = []
    for name in names:
        if name not in ha and name not in hb:
            continue
        ms_a = ha.get(name, {}).get("sum_us", 0) / 1000.0
        ms_b = hb.get(name, {}).get("sum_us", 0) / 1000.0
        regressed = name in ha and name in hb and ms_a > 0 and \
            ms_b >= REGRESSION_RATIO * ms_a
        out.append((name, ms_a, ms_b, regressed))
    return out


def diff_device_failover(counters_a: Dict, counters_b: Dict,
                         ) -> List[Tuple[str, int, int, bool]]:
    """[(counter, a, b, regressed)] over the device.failover containment
    counters present in either run; regressed when B recorded MORE
    containment events than A (any growth — these should be zero on a
    healthy fault-free run, so a ratio threshold would hide 0 -> n)."""
    ga = counters_a.get(DEVICE_FAILOVER_GROUP, {})
    gb = counters_b.get(DEVICE_FAILOVER_GROUP, {})
    out = []
    for name in DEVICE_FAILOVER_COUNTERS:
        if name not in ga and name not in gb:
            continue
        va, vb = int(ga.get(name, 0)), int(gb.get(name, 0))
        out.append((name, va, vb, vb > va))
    return out


def _fmt_hist(s: Dict) -> str:
    if not s:
        return f"{'-':>26}"
    return (f"n={s['count']:<6d} p50={s['p50']:>8.1f} "
            f"p95={s['p95']:>8.1f} max={s['max_ms']:>8.1f}")


def main() -> int:
    if len(sys.argv) != 3:
        print("usage: counter_diff <history_a> <history_b>")
        return 2
    runs, sessions = [], []
    for path in sys.argv[1:]:
        dags = parse_jsonl_files([path])
        if not dags:
            print(f"no DAG in {path}")
            return 1
        runs.append(list(dags.values())[-1])
        sessions.append(dags)
    a, b = runs
    fa, fb = flatten(a.counters), flatten(b.counters)
    print(f"{'counter':60} {'A':>14} {'B':>14} {'delta':>14}")
    for key in sorted(set(fa) | set(fb)):
        va, vb = fa.get(key, 0), fb.get(key, 0)
        if va != vb:
            print(f"{key:60} {va:14d} {vb:14d} {vb - va:+14d}")
    hists = diff_histograms(a.counters, b.counters)
    regressions = 0
    if hists:
        print(f"\n{'latency histogram (ms)':32} {'A':>44} {'B':>44}")
        for name, sa, sb, regressed in hists:
            flag = "  << REGRESSION" if regressed else ""
            print(f"{name:32} {_fmt_hist(sa):>44} {_fmt_hist(sb):>44}{flag}")
            regressions += int(regressed)
    stages = diff_device_stages(a.counters, b.counters)
    if stages:
        tot_a = sum(ms for _, ms, _, _ in stages) or 1.0
        tot_b = sum(ms for _, _, ms, _ in stages) or 1.0
        print(f"\n{'device pipeline stage (wall ms)':32} "
              f"{'A':>16} {'B':>16} {'delta':>12}")
        for name, ms_a, ms_b, regressed in stages:
            flag = "  << REGRESSION" if regressed else ""
            print(f"{name:32} {ms_a:10.1f} {100 * ms_a / tot_a:4.0f}% "
                  f"{ms_b:10.1f} {100 * ms_b / tot_b:4.0f}% "
                  f"{ms_b - ms_a:+12.1f}{flag}")
            regressions += int(regressed)
    merges = diff_device_stages(a.counters, b.counters,
                                names=MERGE_STAGE_HISTS)
    if merges:
        print(f"\n{'reduce-side merge stage (wall ms)':32} "
              f"{'A':>14} {'B':>14} {'delta':>12}")
        for name, ms_a, ms_b, regressed in merges:
            flag = "  << REGRESSION" if regressed else ""
            print(f"{name:32} {ms_a:14.1f} {ms_b:14.1f} "
                  f"{ms_b - ms_a:+12.1f}{flag}")
            regressions += int(regressed)
    store = diff_store(a.counters, b.counters)
    if store:
        print(f"\n{'buffer store (hits/evictions/demotions)':60} "
              f"{'A':>14} {'B':>14}")
        for name, va, vb, regressed in store:
            flag = "  << REGRESSION" if regressed else ""
            print(f"{name:60} {va:14d} {vb:14d}{flag}")
            regressions += int(regressed)
    push = diff_push(a.counters, b.counters)
    if push:
        print(f"\n{'push shuffle (bytes/rejections)':60} "
              f"{'A':>14} {'B':>14}")
        for name, va, vb, regressed in push:
            flag = "  << REGRESSION" if regressed else ""
            print(f"{name:60} {va:14d} {vb:14d}{flag}")
            regressions += int(regressed)
        pushes = diff_device_stages(a.counters, b.counters,
                                    names=PUSH_HISTS)
        if pushes:
            print(f"\n{'push transport (wall ms)':32} "
                  f"{'A':>14} {'B':>14} {'delta':>12}")
            for name, ms_a, ms_b, regressed in pushes:
                flag = "  << REGRESSION" if regressed else ""
                print(f"{name:32} {ms_a:14.1f} {ms_b:14.1f} "
                      f"{ms_b - ms_a:+12.1f}{flag}")
                regressions += int(regressed)
    exchange = diff_exchange(a.counters, b.counters)
    if exchange:
        print(f"\n{'mesh exchange (rows/rounds/splits/coded)':60} "
              f"{'A':>14} {'B':>14}")
        for name, va, vb, regressed in exchange:
            flag = "  << REGRESSION" if regressed else ""
            print(f"{name:60} {va:14d} {vb:14d}{flag}")
            regressions += int(regressed)
        ex_rtt = diff_device_stages(a.counters, b.counters,
                                    names=EXCHANGE_HISTS)
        if ex_rtt:
            print(f"\n{'exchange round (wall ms)':32} "
                  f"{'A':>14} {'B':>14} {'delta':>12}")
            for name, ms_a, ms_b, regressed in ex_rtt:
                flag = "  << REGRESSION" if regressed else ""
                print(f"{name:32} {ms_a:14.1f} {ms_b:14.1f} "
                      f"{ms_b - ms_a:+12.1f}{flag}")
                regressions += int(regressed)
    obs = diff_device_stages(a.counters, b.counters, names=OBS_HISTS)
    if obs:
        print(f"\n{'observability (wall ms)':32} "
              f"{'A':>14} {'B':>14} {'delta':>12}")
        for name, ms_a, ms_b, regressed in obs:
            flag = "  << REGRESSION" if regressed else ""
            print(f"{name:32} {ms_a:14.1f} {ms_b:14.1f} "
                  f"{ms_b - ms_a:+12.1f}{flag}")
            regressions += int(regressed)
    tenants = diff_tenants(*sessions)
    if any(t != "<anon>" or s.get("queued") or s.get("shed")
           for t, sa, sb, _ in tenants for s in (sa, sb) if s):
        print(f"\n{'tenant (admission + latency)':24} "
              f"{'A sub/cmp/fail q/shed p50/p95':>40} "
              f"{'B sub/cmp/fail q/shed p50/p95':>40}")

        def _fmt_tenant(s: Dict) -> str:
            if not s:
                return f"{'-':>40}"
            return (f"{s['submitted']:3d}/{s['completed']:3d}/"
                    f"{s['failed']:2d} {s['queued']:2d}/{s['shed']:2d} "
                    f"{s['p50_s']:6.2f}s/{s['p95_s']:6.2f}s")
        for tenant, sa, sb, regressed in tenants:
            flag = "  << REGRESSION" if regressed else ""
            print(f"{tenant:24} {_fmt_tenant(sa):>40} "
                  f"{_fmt_tenant(sb):>40}{flag}")
            regressions += int(regressed)
    stream = diff_stream(sessions[0], sessions[1])
    if stream:
        print(f"\n{'streaming (windows/replays/lag)':60} "
              f"{'A':>14} {'B':>14}")
        for name, va, vb, regressed in stream:
            flag = "  << REGRESSION" if regressed else ""
            print(f"{name:60} {va:14g} {vb:14g}{flag}")
            regressions += int(regressed)
        stream_h = diff_device_stages(a.counters, b.counters,
                                      names=STREAM_HISTS)
        if stream_h:
            print(f"\n{'stream window (wall ms)':32} "
                  f"{'A':>14} {'B':>14} {'delta':>12}")
            for name, ms_a, ms_b, regressed in stream_h:
                flag = "  << REGRESSION" if regressed else ""
                print(f"{name:32} {ms_a:14.1f} {ms_b:14.1f} "
                      f"{ms_b - ms_a:+12.1f}{flag}")
                regressions += int(regressed)
    recovery = diff_recovery(sessions[0], sessions[1],
                             a.counters, b.counters)
    if recovery:
        print(f"\n{'recovery (requeues/fences/replica failover)':60} "
              f"{'A':>14} {'B':>14}")
        for name, va, vb, regressed in recovery:
            flag = "  << REGRESSION" if regressed else ""
            print(f"{name:60} {va:14d} {vb:14d}{flag}")
            regressions += int(regressed)
    failover = diff_device_failover(a.counters, b.counters)
    if failover:
        print(f"\n{'device.failover (containment)':60} "
              f"{'A':>14} {'B':>14}")
        for name, va, vb, regressed in failover:
            flag = "  << REGRESSION" if regressed else ""
            print(f"{name:60} {va:14d} {vb:14d}{flag}")
            regressions += int(regressed)
    telemetry = diff_telemetry(sessions[0], sessions[1])
    if telemetry:
        print(f"\n{'telemetry plane (rings/collectors/scrapes)':60} "
              f"{'A':>14} {'B':>14}")
        for name, va, vb, regressed in telemetry:
            flag = "  << REGRESSION" if regressed else ""
            print(f"{name:60} {va:14d} {vb:14d}{flag}")
            regressions += int(regressed)
    query = diff_query(sessions[0], sessions[1])
    if query:
        print(f"\n{'query plane (plans/cache hits/replans)':60} "
              f"{'A':>14} {'B':>14}")
        for name, va, vb, regressed in query:
            flag = "  << REGRESSION" if regressed else ""
            print(f"{name:60} {va:14d} {vb:14d}{flag}")
            regressions += int(regressed)
    print(f"\nA: {a.dag_id} ({a.state}, {a.duration:.2f}s)  "
          f"B: {b.dag_id} ({b.state}, {b.duration:.2f}s)  "
          f"wall delta {b.duration - a.duration:+.2f}s")
    if regressions:
        print(f"{regressions} regression(s) (latency p95 >= "
              f"{REGRESSION_RATIO}x baseline, containment event growth, "
              f"store eviction/demotion churn growth, exchange "
              f"round/split growth, tenant shed/failure growth, "
              f"stream replay/abort/lag growth, "
              f"recovery requeue/fence/failover growth, telemetry "
              f"ring-eviction/collector/scrape-error growth, or query "
              f"replan growth)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
