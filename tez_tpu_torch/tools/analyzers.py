"""Post-hoc DAG analyzers over DagInfo.

Reference parity: tez-tools/analyzers/job-analyzer/.../plugins/ via
AnalyzerDriver — full plugin set: CriticalPathAnalyzer:53,
ShuffleTimeAnalyzer, SkewAnalyzer, SpillAnalyzerImpl, SlowestVertexAnalyzer,
ContainerReuseAnalyzer, HungTaskAnalyzer, TaskConcurrencyAnalyzer,
SlowTaskIdentifier, DagOverviewAnalyzer, InputReadErrorAnalyzer,
LocalityAnalyzer, OneOnOneEdgeAnalyzer, SlowNodeAnalyzer,
TaskAssignmentAnalyzer, TaskAttemptResultStatisticsAnalyzer,
VertexLevelCriticalPathAnalyzer (+ speculation and IO-ratio extras).

The port's copy of tez_tpu.tools.analyzers.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from typing import Any, Dict, List, Sequence

from tez_tpu_torch.tools.history_parser import DagInfo, parse_jsonl_files


@dataclasses.dataclass
class AnalyzerResult:
    analyzer: str
    headline: str
    rows: List[Dict[str, Any]]

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class Analyzer:
    name = "abstract"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        raise NotImplementedError


class CriticalPathAnalyzer(Analyzer):
    """Longest chain of vertex (start..finish) spans ordered by start time —
    which vertices bound the DAG wall-clock."""
    name = "critical_path"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        rows = []
        verts = sorted(dag.vertices.values(), key=lambda v: v.start_time)
        total = dag.duration or 1e-9
        for v in verts:
            rows.append({
                "vertex": v.name, "start_offset": v.start_time - dag.start_time,
                "duration": v.duration,
                "fraction_of_dag": round(v.duration / total, 3),
            })
        slowest = max(verts, key=lambda v: v.duration, default=None)
        headline = (f"DAG {dag.name}: {dag.duration:.2f}s; dominant vertex "
                    f"{slowest.name} ({slowest.duration:.2f}s)"
                    if slowest else "empty DAG")
        return AnalyzerResult(self.name, headline, rows)


class ShuffleTimeAnalyzer(Analyzer):
    """Shuffle/merge phase times + bytes per vertex (reference:
    ShuffleTimeAnalyzer over SHUFFLE_PHASE_TIME/MERGE_PHASE_TIME)."""
    name = "shuffle_time"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        rows = []
        for v in dag.vertices.values():
            tc = v.counters.get("TaskCounter", {})
            if not tc.get("SHUFFLE_BYTES") and not tc.get("SHUFFLE_PHASE_TIME"):
                continue
            rows.append({
                "vertex": v.name,
                "shuffle_bytes": tc.get("SHUFFLE_BYTES", 0),
                "shuffle_phase_ms": tc.get("SHUFFLE_PHASE_TIME", 0),
                "merge_phase_ms": tc.get("MERGE_PHASE_TIME", 0),
                "shuffled_inputs": tc.get("NUM_SHUFFLED_INPUTS", 0),
                "failed_fetches": tc.get("NUM_FAILED_SHUFFLE_INPUTS", 0),
            })
        total = sum(r["shuffle_bytes"] for r in rows)
        return AnalyzerResult(self.name,
                              f"total shuffled: {total} bytes", rows)


class SkewAnalyzer(Analyzer):
    """Attempt-duration skew per vertex (reference: SkewAnalyzer)."""
    name = "skew"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        rows = []
        for v in dag.vertices.values():
            durations = [t.successful_attempt.duration
                         for t in v.tasks.values()
                         if t.successful_attempt is not None]
            if not durations:
                continue
            mean = sum(durations) / len(durations)
            rows.append({
                "vertex": v.name, "tasks": len(durations),
                "mean_s": round(mean, 3),
                "max_s": round(max(durations), 3),
                "skew_ratio": round(max(durations) / mean, 2) if mean else 0,
            })
        worst = max(rows, key=lambda r: r["skew_ratio"], default=None)
        return AnalyzerResult(
            self.name,
            f"worst skew {worst['skew_ratio']}x in {worst['vertex']}"
            if worst else "no completed tasks", rows)


class SpillAnalyzer(Analyzer):
    """Spilled records / host-spill bytes per vertex (reference:
    SpillAnalyzerImpl)."""
    name = "spill"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        rows = []
        for v in dag.vertices.values():
            tc = v.counters.get("TaskCounter", {})
            rows.append({
                "vertex": v.name,
                "spilled_records": tc.get("SPILLED_RECORDS", 0),
                "additional_spill_count": tc.get("ADDITIONAL_SPILL_COUNT", 0),
                "host_spill_bytes": tc.get("HOST_SPILL_BYTES", 0),
                "output_bytes": tc.get("OUTPUT_BYTES", 0),
            })
        total = sum(r["host_spill_bytes"] for r in rows)
        return AnalyzerResult(self.name, f"host spill: {total} bytes", rows)


class SlowestVertexAnalyzer(Analyzer):
    name = "slowest_vertex"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        rows = sorted(
            ({"vertex": v.name, "duration_s": round(v.duration, 3),
              "num_tasks": v.num_tasks}
             for v in dag.vertices.values()),
            key=lambda r: -r["duration_s"])
        return AnalyzerResult(
            self.name,
            f"slowest: {rows[0]['vertex']}" if rows else "none", rows)


class ContainerReuseAnalyzer(Analyzer):
    """Tasks per runner (reference: ContainerReuseAnalyzer)."""
    name = "container_reuse"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        rows = [{"container": cid, **info}
                for cid, info in dag.containers.items()]
        total = sum(r.get("tasks_run", 0) for r in rows)
        return AnalyzerResult(
            self.name,
            f"{len(rows)} runners, {total} tasks ("
            f"{total / len(rows):.1f} tasks/runner)" if rows else "no runners",
            rows)


class SpeculationAnalyzer(Analyzer):
    """Attempts beyond the first per task (reference: SpeculationAnalyzer)."""
    name = "speculation"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        rows = []
        for v in dag.vertices.values():
            for t in v.tasks.values():
                if len(t.attempts) > 1:
                    rows.append({"task": t.task_id,
                                 "vertex": v.name,
                                 "attempts": len(t.attempts),
                                 "states": sorted(a.state for a in
                                                  t.attempts.values())})
        return AnalyzerResult(self.name,
                              f"{len(rows)} tasks with extra attempts", rows)


class HungTaskAnalyzer(Analyzer):
    """Tasks started but never finished (reference: HungTaskAnalyzer)."""
    name = "hung_tasks"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        rows = []
        for v in dag.vertices.values():
            for t in v.tasks.values():
                if t.start_time and not t.finish_time:
                    rows.append({"task": t.task_id, "vertex": v.name})
        return AnalyzerResult(self.name, f"{len(rows)} hung tasks", rows)


class TaskConcurrencyAnalyzer(Analyzer):
    """Peak/avg concurrently-running attempts over time (reference:
    TaskConcurrencyAnalyzer)."""
    name = "task_concurrency"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        attempts = [a for a in dag.all_attempts() if a.start_time]
        # open intervals (in-progress/crashed DAGs) close at the latest
        # timestamp seen, never at the 0.0 "unset" sentinel
        horizon = max([dag.finish_time] +
                      [a.finish_time for a in attempts] +
                      [a.start_time for a in attempts], default=0.0)
        points = []
        for a in attempts:
            points.append((a.start_time, 1))
            points.append((a.finish_time or horizon, -1))
        points.sort()
        cur = peak = 0
        area = 0.0
        last_t = points[0][0] if points else 0
        for t, d in points:
            area += cur * (t - last_t)
            cur += d
            peak = max(peak, cur)
            last_t = t
        span = dag.duration or 1e-9
        return AnalyzerResult(
            self.name,
            f"peak {peak} concurrent attempts, avg {area / span:.1f}",
            [{"peak": peak, "avg": round(area / span, 2)}])


class SlowTaskAttemptAnalyzer(Analyzer):
    """Slowest attempts across the DAG (reference: SlowTaskIdentifier)."""
    name = "slow_attempts"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        attempts = sorted(dag.all_attempts(), key=lambda a: -a.duration)[:10]
        rows = [{"attempt": a.attempt_id, "vertex": a.vertex_name,
                 "duration_s": round(a.duration, 3), "state": a.state}
                for a in attempts]
        return AnalyzerResult(
            self.name,
            f"slowest attempt {rows[0]['duration_s']}s in "
            f"{rows[0]['vertex']}" if rows else "none", rows)


class InputOutputRatioAnalyzer(Analyzer):
    """Bytes out / bytes in per vertex — where data amplifies or reduces
    (reference: the IO-ratio family of analyzers)."""
    name = "io_ratio"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        rows = []
        for v in dag.vertices.values():
            tc = v.counters.get("TaskCounter", {})
            inp = tc.get("SHUFFLE_BYTES", 0) or \
                tc.get("INPUT_SPLIT_LENGTH_BYTES", 0)
            out = tc.get("OUTPUT_BYTES", 0)
            if inp or out:
                rows.append({"vertex": v.name, "in_bytes": inp,
                             "out_bytes": out,
                             "ratio": round(out / inp, 3) if inp else None})
        return AnalyzerResult(self.name, f"{len(rows)} vertices with IO",
                              rows)


class DagOverviewAnalyzer(Analyzer):
    """One-row-per-vertex DAG summary (reference: DagOverviewAnalyzer)."""
    name = "dag_overview"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        rows = []
        for v in sorted(dag.vertices.values(), key=lambda v: v.start_time):
            states: Dict[str, int] = {}
            for t in v.tasks.values():
                states[t.state or "RUNNING"] = \
                    states.get(t.state or "RUNNING", 0) + 1
            rows.append({
                "vertex": v.name, "state": v.state, "num_tasks": v.num_tasks,
                "task_states": states,
                "duration_s": round(v.duration, 3),
            })
            first = min((t.start_time for t in v.tasks.values()
                         if t.start_time), default=v.start_time)
            # vertices that never started (upstream failure) have no offset
            rows[-1]["first_task_start_offset"] = \
                round(first - dag.start_time, 3) if first else None
        return AnalyzerResult(
            self.name,
            f"{dag.name}: {dag.state}, {len(rows)} vertices, "
            f"{sum(r['num_tasks'] for r in rows)} tasks, "
            f"{dag.duration:.2f}s", rows)


class InputReadErrorAnalyzer(Analyzer):
    """Fetch failures and output-loss reruns (reference:
    InputReadErrorAnalyzer over INPUT_READ_ERROR events)."""
    name = "input_read_errors"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        rows = []
        for a in dag.all_attempts():
            failed = a.counter("TaskCounter", "NUM_FAILED_SHUFFLE_INPUTS")
            output_lost = "output lost" in (a.diagnostics or "")
            if failed or output_lost:
                rows.append({"attempt": a.attempt_id, "vertex": a.vertex_name,
                             "failed_fetches": failed,
                             "output_lost_rerun": output_lost,
                             "state": a.state})
        return AnalyzerResult(
            self.name,
            f"{sum(r['failed_fetches'] for r in rows)} failed fetches, "
            f"{sum(r['output_lost_rerun'] for r in rows)} output-loss reruns",
            rows)


class LocalityAnalyzer(Analyzer):
    """Local vs remote shuffle reads per vertex (reference: LocalityAnalyzer
    over DATA_LOCAL_TASKS; here locality = same-host buffer handoff vs DCN
    fetch, SURVEY.md §2.10)."""
    name = "locality"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        rows = []
        for v in dag.vertices.values():
            tc = v.counters.get("TaskCounter", {})
            local = tc.get("LOCAL_SHUFFLED_INPUTS", 0)
            total = tc.get("NUM_SHUFFLED_INPUTS", 0)
            if total:
                rows.append({"vertex": v.name, "shuffled_inputs": total,
                             "local_inputs": local,
                             "local_fraction": round(local / total, 3)})
        return AnalyzerResult(
            self.name,
            (f"{sum(r['local_inputs'] for r in rows)}/"
             f"{sum(r['shuffled_inputs'] for r in rows)} inputs read locally"
             if rows else "no shuffled inputs"), rows)


class OneOnOneEdgeAnalyzer(Analyzer):
    """For ONE_TO_ONE edges: did task i of src and dst land on the same
    node (affinity working)? (reference: OneOnOneEdgeAnalyzer)."""
    name = "one_on_one_edges"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        def placement(vertex_name: str) -> Dict[int, str]:
            v = dag.vertex(vertex_name)
            out: Dict[int, str] = {}
            if v is None:
                return out
            for t in v.tasks.values():
                a = t.successful_attempt
                if a is None:
                    continue
                try:
                    idx = int(t.task_id.rsplit("_", 1)[1])
                except (ValueError, IndexError):
                    continue
                where = a.node_id or a.container_id
                if where:          # unknown placement must not count as a
                    out[idx] = where   # colocated ''=='' match
            return out

        rows = []
        for e in dag.edges:
            if e.get("movement") != "ONE_TO_ONE":
                continue
            src, dst = placement(e["src"]), placement(e["dst"])
            common = set(src) & set(dst)
            colocated = sum(1 for i in common if src[i] == dst[i])
            rows.append({"edge": f"{e['src']}->{e['dst']}",
                         "pairs": len(common), "colocated": colocated})
        return AnalyzerResult(
            self.name,
            f"{len(rows)} ONE_TO_ONE edges" if rows
            else "no ONE_TO_ONE edges", rows)


class SlowNodeAnalyzer(Analyzer):
    """Mean attempt duration + failure count per node — is one host slow or
    flaky? (reference: SlowNodeAnalyzer)."""
    name = "slow_nodes"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        per_node: Dict[str, List] = {}
        for a in dag.all_attempts():
            if not a.finish_time:
                continue
            per_node.setdefault(a.node_id or a.container_id or "?",
                                []).append(a)
        rows = []
        for node, atts in sorted(per_node.items()):
            durs = [a.duration for a in atts]
            rows.append({
                "node": node, "attempts": len(atts),
                "mean_s": round(sum(durs) / len(durs), 3),
                "failed": sum(1 for a in atts if a.state == "FAILED"),
            })
        slowest = max(rows, key=lambda r: r["mean_s"], default=None)
        return AnalyzerResult(
            self.name,
            f"slowest node {slowest['node']} (mean {slowest['mean_s']}s)"
            if slowest else "no finished attempts", rows)


class TaskAssignmentAnalyzer(Analyzer):
    """Attempts per node per vertex — assignment spread (reference:
    TaskAssignmentAnalyzer)."""
    name = "task_assignment"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        rows = []
        for v in dag.vertices.values():
            per_node: Dict[str, int] = {}
            for t in v.tasks.values():
                for a in t.attempts.values():
                    key = a.node_id or a.container_id or "?"
                    per_node[key] = per_node.get(key, 0) + 1
            if per_node:
                rows.append({"vertex": v.name, "per_node": per_node,
                             "nodes_used": len(per_node)})
        return AnalyzerResult(self.name,
                              f"{len(rows)} vertices placed", rows)


class TaskAttemptResultStatisticsAnalyzer(Analyzer):
    """Attempt terminal-state counts per (vertex, node) (reference:
    TaskAttemptResultStatisticsAnalyzer)."""
    name = "attempt_result_stats"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        stats: Dict[tuple, Dict[str, int]] = {}
        for a in dag.all_attempts():
            key = (a.vertex_name, a.node_id or a.container_id or "?")
            bucket = stats.setdefault(key, {})
            state = a.state or "RUNNING"
            bucket[state] = bucket.get(state, 0) + 1
        rows = [{"vertex": v, "node": n, "states": s}
                for (v, n), s in sorted(stats.items())]
        total_failed = sum(s.get("FAILED", 0) for s in stats.values())
        return AnalyzerResult(
            self.name,
            f"{len(rows)} (vertex,node) buckets, {total_failed} failed",
            rows)


class VertexLevelCriticalPathAnalyzer(Analyzer):
    """Longest dependency chain through the DAG's edges weighted by vertex
    durations (reference: VertexLevelCriticalPathAnalyzer; the flat
    CriticalPathAnalyzer above ranks by span only)."""
    name = "vertex_critical_path"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        preds: Dict[str, List[str]] = {}
        for e in dag.edges:
            preds.setdefault(e["dst"], []).append(e["src"])
        names = [v.name for v in dag.vertices.values()]
        durs = {v.name: v.duration for v in dag.vertices.values()}
        memo: Dict[str, tuple] = {}

        def longest(name: str) -> tuple:
            """(total duration, path list) of the heaviest chain ending at
            `name`; cycles are impossible (DAG.verify)."""
            if name in memo:
                return memo[name]
            best = (0.0, [])
            for p in preds.get(name, []):
                cand = longest(p)
                if cand[0] > best[0]:
                    best = cand
            memo[name] = (best[0] + durs.get(name, 0.0), best[1] + [name])
            return memo[name]

        if not names:
            return AnalyzerResult(self.name, "empty DAG", [])
        total, path = max((longest(n) for n in names), key=lambda x: x[0])
        rows = [{"vertex": n, "duration_s": round(durs.get(n, 0.0), 3)}
                for n in path]
        frac = f" ({total / dag.duration:.0%} of DAG)" if dag.duration else \
            " (DAG unfinished)"
        return AnalyzerResult(
            self.name,
            f"critical path {' -> '.join(path)} = {total:.2f}s{frac}", rows)


class NodeHealthAnalyzer(Analyzer):
    """Node blacklist / forced-active transitions correlated with where
    failed attempts ran (reference: SlowNodeAnalyzer's sibling for the
    AMNodeImpl state machine; the chaos harness uses it to attribute
    storms to node flaps)."""
    name = "node_health"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        failed_per_node: Dict[str, int] = {}
        for a in dag.all_attempts():
            if a.state in ("FAILED", "KILLED") and a.node_id:
                failed_per_node[a.node_id] = \
                    failed_per_node.get(a.node_id, 0) + 1
        rows = []
        for ev in dag.node_events:
            rows.append({
                "node": ev["node_id"], "event": ev["event"],
                "node_failures": ev["failures"],
                "offset_s": round(ev["time"] - dag.start_time, 3)
                if dag.start_time else None,
                "failed_attempts_on_node":
                    failed_per_node.get(ev["node_id"], 0)})
        blacklists = sum(1 for r in rows if r["event"] == "BLACKLISTED")
        forced = sum(1 for r in rows if r["event"] == "FORCED_ACTIVE")
        return AnalyzerResult(
            self.name,
            (f"{blacklists} blacklist(s), {forced} forced-active "
             f"transition(s)" if rows else "no node health transitions"),
            rows)


class DeviceHealthAnalyzer(Analyzer):
    """Device-plane failure containment per vertex: host failovers, breaker
    trips/short-circuits, watchdog fires, and OOM split retries from the
    DeviceFailover counter group (async pipeline containment ladder).  A
    vertex with failovers but zero breaker trips rode out isolated faults;
    short-circuits mean the breaker held the device offline for part of
    the run and host-path capacity planning applies."""
    name = "device_health"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        rows = []
        for v in dag.vertices.values():
            df = v.counters.get("DeviceFailover", {})
            if not df:
                continue
            rows.append({
                "vertex": v.name,
                "failover_spans": df.get("device.failover.spans", 0),
                "failover_groups": df.get("device.failover.groups", 0),
                "drained_on_wedge": df.get("device.failover.drained", 0),
                "watchdog_fires": df.get("device.watchdog.fires", 0),
                "breaker_trips": df.get("device.breaker.trips", 0),
                "breaker_short_circuits":
                    df.get("device.breaker.short_circuits", 0),
                "breaker_recoveries": df.get("device.breaker.recoveries", 0),
                "oom_split_attempts": df.get("device.oom.split_attempts", 0),
                "oom_split_success": df.get("device.oom.split_success", 0),
            })
        spans = sum(r["failover_spans"] for r in rows)
        trips = sum(r["breaker_trips"] for r in rows)
        fires = sum(r["watchdog_fires"] for r in rows)
        headline = "device plane healthy (no containment events)" if not rows \
            else (f"{spans} span(s) failed over to host; "
                  f"{trips} breaker trip(s), {fires} watchdog fire(s)")
        return AnalyzerResult(self.name, headline, rows)


class SpanCriticalPathAnalyzer(Analyzer):
    """Span-based critical path over the live tracing buffer: the longest
    causal chain through the recorded spans (tracing plane, this PR's
    tentpole), naming which vertex/fetch/commit span dominates wall clock.
    Unlike CriticalPathAnalyzer (history timestamps, vertex granularity)
    this sees intra-attempt structure — a fetch stall or merge dominating a
    vertex shows up by name.  Empty when the DAG ran with tracing disarmed."""
    name = "span_critical_path"

    def analyze(self, dag: DagInfo) -> AnalyzerResult:
        from tez_tpu_torch.common import tracing
        from tez_tpu_torch.tools.trace_export import critical_path_report
        spans = tracing.snapshot()
        # scope to this DAG's trace when its root span is in the buffer
        # (the buffer is process-global and may hold several DAGs)
        dag_traces = {sp.trace_id for sp in spans
                      if sp.cat == "dag" and
                      sp.args.get("dag_id") == str(dag.dag_id)}
        if dag_traces:
            spans = [sp for sp in spans if sp.trace_id in dag_traces]
        if not spans:
            return AnalyzerResult(
                self.name,
                "no spans recorded (run with tez.trace.enabled=True)", [])
        report = critical_path_report(spans)
        dom = report["dominant"]
        chain = report["chain"]
        # dominant VERTEX: attribute each chain span's self time to the
        # nearest enclosing span that names a vertex (the attempt span),
        # then take the vertex holding the most on-path time.  The dag
        # root's own self time (AM scheduling overhead) stays unattributed.
        per_vertex: Dict[str, float] = {}
        cur = ""
        for c in chain:
            cur = c.get("vertex") or cur
            if cur:
                per_vertex[cur] = per_vertex.get(cur, 0) + c.get("self_ms", 0)
        headline = "no dominant span"
        if dom:
            headline = (f"critical chain of {len(chain)} span(s); dominant: "
                        f"{dom['name']} ({dom['duration_ms']:.1f}ms)")
            if per_vertex:
                v, ms = max(per_vertex.items(), key=lambda kv: kv[1])
                headline += f"; dominant vertex: {v} ({ms:.1f}ms on path)"
        return AnalyzerResult(self.name, headline, chain)


ALL_ANALYZERS: Sequence[Analyzer] = (
    SpanCriticalPathAnalyzer(),
    CriticalPathAnalyzer(), ShuffleTimeAnalyzer(), SkewAnalyzer(),
    SpillAnalyzer(), SlowestVertexAnalyzer(), ContainerReuseAnalyzer(),
    SpeculationAnalyzer(), HungTaskAnalyzer(), TaskConcurrencyAnalyzer(),
    SlowTaskAttemptAnalyzer(), InputOutputRatioAnalyzer(),
    DagOverviewAnalyzer(), InputReadErrorAnalyzer(), LocalityAnalyzer(),
    OneOnOneEdgeAnalyzer(), SlowNodeAnalyzer(), NodeHealthAnalyzer(),
    DeviceHealthAnalyzer(),
    TaskAssignmentAnalyzer(), TaskAttemptResultStatisticsAnalyzer(),
    VertexLevelCriticalPathAnalyzer())


def analyze_dag(dag: DagInfo,
                analyzers: Sequence[Analyzer] = ALL_ANALYZERS
                ) -> List[AnalyzerResult]:
    return [a.analyze(dag) for a in analyzers]


def main() -> int:
    """AnalyzerDriver CLI: python -m tez_tpu_torch.tools.analyzers <jsonl...>
    or --cache-dir <dir> [dag_id...] (timeline-cache-backed reads)."""
    if len(sys.argv) < 2:
        print("usage: analyzers <history.jsonl | dir | glob>... | "
              "--cache-dir <dir> [dag_id...]")
        return 2
    if sys.argv[1] == "--cache-dir":
        if len(sys.argv) < 3:
            print("usage: analyzers --cache-dir <dir> [dag_id...]")
            return 2
        from tez_tpu_torch.tools.history_cache import DagInfoCache
        cache = DagInfoCache(sys.argv[2])
        wanted = sys.argv[3:]
        dags = {i: d for i, d in cache.all().items()
                if not wanted or i in wanted}
    else:
        dags = parse_jsonl_files(sys.argv[1:])
    if not dags:
        print("no DAGs found")
        return 1
    for dag in dags.values():
        print(f"=== {dag.dag_id} ({dag.name}) state={dag.state} "
              f"duration={dag.duration:.2f}s ===")
        for result in analyze_dag(dag):
            print(f"[{result.analyzer}] {result.headline}")
            for row in result.rows:
                print("   ", json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
