"""Live AM web UI: JSON REST surface + single-page app.

Reference parity: tez-dag/.../app/web/{AMWebController.java:69,
WebUIService.java} (the live REST surface) plus the tez-ui SPA feature set
(tez-ui/src/main/webapp/app/: DAG/vertex/task/attempt browsing, counters,
DAG graph view, swimlane) — rebuilt as a zero-dependency single page served
by the AM itself instead of an Ember app reading ATS.

Endpoints:
  GET /                 single-page app (tabs: overview, graph, tasks,
                        counters, config, swimlane, history, analyzers)
  GET /status           JSON DAG status (DAGClient schema)
  GET /dags             JSON all DAGs this session (session mode)
  GET /graph            JSON DAG structure (vertices + typed edges)
  GET /tasks?vertex=N   JSON per-task/attempt detail for one vertex
  GET /attempt?id=A     JSON one attempt's counters/diagnostics/timing
  GET /counters         JSON aggregated DAG counters
  GET /counters?vertex=N  per-vertex counter aggregation
  GET /conf             JSON effective DAG configuration (secrets redacted)
  GET /history          JSON recent history events (in-memory logger only)
  GET /analyzers        JSON analyzer suite run over live history
  GET /swimlane.svg     container swimlane SVG
  GET /trace            Chrome/Perfetto trace_event JSON (span buffer, or
                        history-derived when tracing was disarmed)
  GET /metrics          Prometheus text: counters, latency histograms,
                        running-task/queued-fetch/epoch gauges; dynamic
                        series split into tenant=/stream=/lane= labels
                        (?tenant=X / ?stream=Y drill down)
  GET /metrics.json     structured JSON exposition + windowed aggregates
                        from the live time-series rings (?window=SECONDS)
  GET /doctor/live      continuous doctor: incremental per-plane blame,
                        tenants, streams, queue depth, lane occupancy

The port's copy of tez_tpu.am.web, wired into the port's DAGAppMaster by
``tez.am.web.enabled`` as tez_tpu's is.
"""
from __future__ import annotations

import http.server
import json
import logging
import threading
import urllib.parse
from typing import Any, Dict, List, Optional

from tez_tpu_torch.common import clock

log = logging.getLogger(__name__)

_PAGE = """<!doctype html><html><head><title>tez_tpu AM</title><style>
body{font-family:monospace;margin:1.5em;background:#fafafa}
table{border-collapse:collapse;margin-top:8px}
td,th{border:1px solid #bbb;padding:3px 9px;text-align:left;font-size:13px}
th{background:#eee}
.bar{background:#ddd;width:200px;display:inline-block}
.fill{background:#4e79a7;height:11px}
.tabs button{font-family:monospace;padding:6px 14px;border:1px solid #999;
 background:#eee;cursor:pointer;margin-right:4px}
.tabs button.on{background:#4e79a7;color:#fff}
#panel{margin-top:12px}
.SUCCEEDED{color:#2a7d2a}.FAILED{color:#c0392b}.RUNNING{color:#2471a3}
.KILLED{color:#8e44ad}
svg text{font-family:monospace;font-size:12px}
.hl{font-weight:bold}
</style></head><body>
<h2 id="t">tez_tpu AM</h2>
<div class="tabs" id="tabs"></div><div id="panel"></div>
<script>
const TABS = ["overview","graph","tasks","counters","config","swimlane",
              "history","analyzers"];
let cur = "overview", selVertex = null, timer = null, gen = 0;
let selAttempt = null, taskFilter = "", counterVertex = "";
const $ = id => document.getElementById(id);
const esc = s => String(s).replace(/[&<>]/g,
  c => ({'&':'&amp;','<':'&lt;','>':'&gt;'}[c]));
function tabbar() {
  $('tabs').innerHTML = TABS.map(t =>
    `<button class="${t===cur?'on':''}" onclick="go('${t}')">${t}</button>`
  ).join('');
}
function go(t) { cur = t; tabbar(); render(); }
async function j(path) { return (await fetch(path)).json(); }
async function head() {
  const s = await j('/status');
  $('t').innerHTML = s.name ?
    `${esc(s.name)} — <span class="${esc(s.state)}">${esc(s.state)}</span>` +
    ` (${Math.round(s.progress*100)}%)` : 'tez_tpu AM — idle';
  return s;
}
async function render() {
  // generation counter: a tab switch mid-fetch invalidates this render so it
  // neither clobbers the new tab's panel nor schedules a duplicate poll loop
  const g = ++gen;
  clearTimeout(timer);
  try {
  const s = await head();
  if (g !== gen) return;
  if (cur === 'overview') {
    let h = '<table><tr><th>vertex</th><th>state</th><th>tasks</th>' +
            '<th>progress</th></tr>';
    for (const [n,v] of Object.entries(s.vertices || {}))
      h += `<tr><td>${esc(n)}</td><td class="${esc(v.state)}">${esc(v.state)}` +
           `</td><td>${v.succeeded}/${v.total_tasks}</td>` +
           `<td><div class="bar"><div class="fill" style="width:` +
           `${Math.round(v.progress*200)}px"></div></div></td></tr>`;
    h += '</table>';
    const dags = await j('/dags');
    if (g !== gen) return;
    if (dags.length > 1) {
      h += '<h3>session DAGs</h3><table><tr><th>dag</th><th>state</th></tr>';
      for (const d of dags)
        h += `<tr><td>${esc(d.dag_id)} (${esc(d.name)})</td>` +
             `<td class="${esc(d.state)}">${esc(d.state)}</td></tr>`;
      h += '</table>';
    }
    $('panel').innerHTML = h;
  } else if (cur === 'graph') {
    const gr = await j('/graph');
    if (g !== gen) return;
    $('panel').innerHTML = drawGraph(gr);
  } else if (cur === 'tasks') {
    const names = Object.keys(s.vertices || {});
    if (!selVertex || !names.includes(selVertex)) selVertex = names[0];
    let h = 'vertex: ' +
      '<select onchange="selVertex=this.value;selAttempt=null;render()">' +
      names.map(n =>
        `<option ${n===selVertex?'selected':''}>${esc(n)}</option>`).join('') +
      '</select> state filter: ' +
      '<select onchange="taskFilter=this.value;render()">' +
      ['','RUNNING','SUCCEEDED','FAILED','KILLED','SCHEDULED'].map(f =>
        `<option ${f===taskFilter?'selected':''}>${f}</option>`).join('') +
      '</select>';
    if (selVertex) {
      const rows = await j('/tasks?vertex=' + encodeURIComponent(selVertex));
      if (g !== gen) return;
      h += '<table><tr><th>task</th><th>state</th><th>attempt</th>' +
           '<th>attempt state</th><th>node</th><th>duration</th></tr>';
      for (const t of rows) {
        if (taskFilter && t.state !== taskFilter &&
            !t.attempts.some(a => a.state === taskFilter)) continue;
        if (!t.attempts.length)
          h += `<tr><td>${t.index}</td><td class="${esc(t.state)}">` +
               `${esc(t.state)}</td><td colspan=4></td></tr>`;
        for (const a of t.attempts)
          h += `<tr><td>${t.index}</td><td class="${esc(t.state)}">` +
               `${esc(t.state)}</td>` +
               `<td><a href="#" onclick="selAttempt='${esc(a.id)}';` +
               `render();return false">${esc(a.id)}</a></td>` +
               `<td class="${esc(a.state)}">${esc(a.state)}</td>` +
               `<td>${esc(a.node)}</td><td>${a.duration_s}s</td></tr>`;
      }
      h += '</table>';
      if (selAttempt) {
        const d = await j('/attempt?id=' + encodeURIComponent(selAttempt));
        if (g !== gen) return;
        if (!d.error) {
          h += `<h3>${esc(d.id)} — <span class="${esc(d.state)}">` +
               `${esc(d.state)}</span> on ${esc(d.node)} ` +
               `(${d.duration_s}s) ` +
               `<button onclick="selAttempt=null;render()">close</button>` +
               `</h3>`;
          if (d.diagnostics.length)
            h += '<pre style="color:#c0392b">' +
                 d.diagnostics.map(esc).join('\\n') + '</pre>';
          for (const [grp, cs] of Object.entries(d.counters)) {
            h += `<h4>${esc(grp)}</h4><table>`;
            for (const [k,v] of Object.entries(cs))
              h += `<tr><td>${esc(k)}</td>` +
                   `<td style="text-align:right">${v}</td></tr>`;
            h += '</table>';
          }
        }
      }
    }
    $('panel').innerHTML = h;
  } else if (cur === 'counters') {
    const names = Object.keys(s.vertices || {});
    let h = 'scope: <select onchange="counterVertex=this.value;render()">' +
      ['<option value="">DAG total</option>'].concat(names.map(n =>
        `<option value="${esc(n)}" ${n===counterVertex?'selected':''}>` +
        `${esc(n)}</option>`)).join('') + '</select>';
    const c = await j('/counters' + (counterVertex ?
      '?vertex=' + encodeURIComponent(counterVertex) : ''));
    if (g !== gen) return;
    for (const [grp, cs] of Object.entries(c)) {
      h += `<h3>${esc(grp)}</h3><table>`;
      for (const [k,v] of Object.entries(cs))
        h += `<tr><td>${esc(k)}</td><td style="text-align:right">${v}</td></tr>`;
      h += '</table>';
    }
    $('panel').innerHTML = h;
  } else if (cur === 'config') {
    const c = await j('/conf');
    if (g !== gen) return;
    let h = '<table><tr><th>key</th><th>value</th></tr>';
    for (const k of Object.keys(c).sort())
      h += `<tr><td>${esc(k)}</td><td>${esc(JSON.stringify(c[k]))}</td></tr>`;
    $('panel').innerHTML = h + '</table>';
  } else if (cur === 'swimlane') {
    $('panel').innerHTML =
      `<img src="/swimlane.svg?ts=${Date.now()}" style="max-width:100%">`;
  } else if (cur === 'history') {
    const evs = await j('/history');
    if (g !== gen) return;
    let h = '<table><tr><th>time</th><th>event</th><th>entity</th></tr>';
    for (const e of evs.slice(-80).reverse())
      h += `<tr><td>${new Date(e.timestamp*1000).toLocaleTimeString()}</td>` +
           `<td>${esc(e.event_type)}</td>` +
           `<td>${esc(e.attempt_id||e.task_id||e.vertex_id||e.dag_id||'')}` +
           `</td></tr>`;
    $('panel').innerHTML = h + '</table>';
  } else if (cur === 'analyzers') {
    const rs = await j('/analyzers');
    if (g !== gen) return;
    let h = '<table><tr><th>analyzer</th><th>headline</th></tr>';
    for (const r of rs)
      h += `<tr><td class="hl">${esc(r.analyzer)}</td>` +
           `<td>${esc(r.headline)}</td></tr>`;
    $('panel').innerHTML = h + '</table>';
  }
  } catch (e) {
    // a transient fetch error (AM busy, DAG transition) must not kill the
    // poll loop; show it and keep polling
    if (g !== gen) return;
    $('panel').innerHTML = '<i>fetch failed, retrying: ' + esc(e) + '</i>';
  }
  if (g !== gen) return;
  timer = setTimeout(render, cur === 'overview' || cur === 'graph' ||
                             cur === 'tasks' ? 2000 : 10000);
}
function drawGraph(g) {
  // layered layout by distance-from-root
  const lanes = {};
  for (const v of g.vertices)
    (lanes[v.distance] = lanes[v.distance] || []).push(v);
  const pos = {}, W = 190, H = 90;
  let maxX = 0, maxY = 0;
  for (const [d, vs] of Object.entries(lanes))
    vs.forEach((v, i) => {
      pos[v.name] = {x: 40 + i*W, y: 40 + d*H};
      maxX = Math.max(maxX, 40 + i*W); maxY = Math.max(maxY, 40 + d*H);
    });
  let s = `<svg width="${maxX+220}" height="${maxY+90}" ` +
          `xmlns="http://www.w3.org/2000/svg">`;
  s += '<defs><marker id="ar" viewBox="0 0 10 10" refX="9" refY="5" ' +
       'markerWidth="7" markerHeight="7" orient="auto-start-reverse">' +
       '<path d="M 0 0 L 10 5 L 0 10 z" fill="#666"/></marker></defs>';
  for (const e of g.edges) {
    const a = pos[e.src], b = pos[e.dst];
    if (!a || !b) continue;
    const x1=a.x+80, y1=a.y+44, x2=b.x+80, y2=b.y;
    s += `<line x1="${x1}" y1="${y1}" x2="${x2}" y2="${y2}" stroke="#666" ` +
         `marker-end="url(#ar)"/>` +
         `<text x="${(x1+x2)/2+4}" y="${(y1+y2)/2}" fill="#888">` +
         `${esc(e.movement.toLowerCase())}</text>`;
  }
  const fill = {SUCCEEDED:'#d5e8d4',FAILED:'#f8cecc',RUNNING:'#dae8fc',
                KILLED:'#e1d5e7'};
  for (const v of g.vertices) {
    const p = pos[v.name];
    s += `<rect x="${p.x}" y="${p.y}" width="160" height="44" rx="6" ` +
         `fill="${fill[v.state]||'#eee'}" stroke="#666"/>` +
         `<text x="${p.x+10}" y="${p.y+18}">${esc(v.name)}</text>` +
         `<text x="${p.x+10}" y="${p.y+35}" fill="#555">${esc(v.state)} ` +
         `${v.succeeded}/${v.tasks}</text>`;
  }
  return s + '</svg>';
}
tabbar(); render();
</script></body></html>"""


class _Handler(http.server.BaseHTTPRequestHandler):
    def log_message(self, *args: Any) -> None:
        pass

    def do_GET(self) -> None:  # noqa: N802 — stdlib naming
        am = self.server.am  # type: ignore[attr-defined]
        parsed = urllib.parse.urlparse(self.path)
        path, query = parsed.path, urllib.parse.parse_qs(parsed.query)
        try:
            self._route(am, path, query)
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001 — a UI bug must not kill the AM
            log.exception("web ui error for %s", self.path)
            try:
                self._send(500, json.dumps({"error": repr(e)}).encode())
            except Exception:  # noqa: BLE001
                pass

    def _route(self, am: Any, path: str, query: Dict[str, List[str]]) -> None:
        if path == "/":
            self._send(200, _PAGE.encode(), "text/html")
        elif path == "/status":
            dag = am.current_dag
            body = dag.status_dict() if dag is not None else {
                "name": None, "state": "IDLE", "progress": 0, "vertices": {}}
            self._send(200, json.dumps(body, default=str).encode())
        elif path == "/dags":
            self._send(200, json.dumps(self._dags(am)).encode())
        elif path == "/queue":
            self._send(200, json.dumps(self._queue(am),
                                       default=str).encode())
        elif path == "/graph":
            self._send(200, json.dumps(self._graph(am), default=str).encode())
        elif path == "/tasks":
            name = (query.get("vertex") or [""])[0]
            self._send(200, json.dumps(self._tasks(am, name),
                                       default=str).encode())
        elif path == "/counters":
            vertex = (query.get("vertex") or [""])[0]
            self._send(200, json.dumps(
                self._counters(am, vertex)).encode())
        elif path == "/attempt":
            aid = (query.get("id") or [""])[0]
            self._send(200, json.dumps(self._attempt(am, aid),
                                       default=str).encode())
        elif path == "/conf":
            self._send(200, json.dumps(self._conf(am),
                                       default=str).encode())
        elif path == "/swimlane.svg":
            from tez_tpu_torch.tools.swimlane import render_svg
            dag = self._parsed_dag(am)
            if dag is not None:
                svg = render_svg(dag)
                self._send(200, svg.encode(), "image/svg+xml")
            else:
                self._send(404, b'{"error": "no DAG yet"}')
        elif path == "/nodes":
            tracker = getattr(am, "node_tracker", None)
            body = tracker.snapshot() if tracker is not None else {}
            self._send(200, json.dumps(body).encode())
        elif path == "/history":
            events = getattr(am.logging_service, "events", [])
            body = [json.loads(e.to_json()) for e in events[-200:]]
            self._send(200, json.dumps(body).encode())
        elif path == "/analyzers":
            self._send(200, json.dumps(self._analyzers(am),
                                       default=str).encode())
        elif path == "/trace":
            self._send(200, json.dumps(self._trace(am)).encode())
        elif path == "/slo":
            self._send(200, json.dumps(self._slo(am)).encode())
        elif path in ("/metrics", "/metrics.json"):
            from tez_tpu_torch.common import config as C
            conf = getattr(am, "conf", None)
            if conf is not None and not bool(conf.get(C.METRICS_ENABLED)):
                self._send(404, b'{"error": "tez.metrics.enabled is off"}')
                return
            tenant = (query.get("tenant") or [None])[0]
            stream = (query.get("stream") or [None])[0]
            try:
                if path == "/metrics":
                    body, ctype = (self._metrics(am, tenant, stream)
                                   .encode(),
                                   "text/plain; version=0.0.4; "
                                   "charset=utf-8")
                else:
                    window = float((query.get("window") or ["0"])[0] or 0)
                    body, ctype = (json.dumps(self._metrics_json(
                        am, tenant, stream, window)).encode(),
                        "application/json")
            except Exception:
                # scrape-error accounting lives in the plane that broke,
                # so counter_diff can flag scrape health across runs
                from tez_tpu_torch.obs import timeseries
                timeseries.registry().note_scrape_error()
                raise
            self._send(200, body, ctype)
        elif path == "/doctor/live":
            sampler = getattr(am, "telemetry", None)
            if sampler is None:
                self._send(404, b'{"error": "no telemetry sampler"}')
            else:
                window = float((query.get("window") or ["0"])[0] or 0)
                self._send(200, json.dumps(
                    sampler.live_status(window or None),
                    default=str).encode())
        else:
            self._send(404, b'{"error": "not found"}')

    @staticmethod
    def _dags(am: Any) -> List[Dict[str, Any]]:
        names = getattr(am, "completed_dag_names", {})
        # list() snapshots are atomic under the GIL; these dicts are mutated
        # by the dispatcher thread while we serve
        out = [{"dag_id": d, "name": names.get(d, ""), "state": s.name}
               for d, s in list(am.completed_dags.items())]
        live = list(getattr(am, "live_dags", {}).values())
        if not live and am.current_dag is not None:
            live = [am.current_dag]
        for dag in live:
            if str(dag.dag_id) not in am.completed_dags:
                out.append({"dag_id": str(dag.dag_id), "name": dag.name,
                            "state": dag.state.name,
                            "tenant": getattr(dag, "tenant", "")})
        return out

    @staticmethod
    def _queue(am: Any) -> Dict[str, Any]:
        """Admission/queue snapshot: queue depth, per-tenant in-flight/
        queued/shed counts, plus per-tenant resident store bytes."""
        status = am.queue_status() if hasattr(am, "queue_status") else {}
        from tez_tpu_torch.store import local_buffer_store
        store = local_buffer_store()
        if store is not None:
            status["store_tenant_bytes"] = store.tenant_bytes()
        return status

    @staticmethod
    def _slo(am: Any) -> Dict[str, Any]:
        """SLO watchdog surface: declared targets, latched active
        breaches, and the bounded breach/clear transition log."""
        wd = getattr(am, "slo_watchdog", None)
        if wd is None:
            return {"enabled": False, "targets": {}, "active": [],
                    "total_breaches": 0, "log": []}
        return wd.status()

    @staticmethod
    def _graph(am: Any) -> Dict[str, Any]:
        dag = am.current_dag
        if dag is None:
            return {"vertices": [], "edges": []}
        vertices = [{
            "name": v.name, "state": v.state.name,
            "tasks": v.num_tasks, "succeeded": v.succeeded_tasks,
            "distance": v.distance_from_root,
        } for v in list(dag.vertices.values())]
        edges = [{
            "src": e.source_vertex.name, "dst": e.destination_vertex.name,
            "movement": e.edge_property.data_movement_type.name,
        } for e in list(dag.edges.values())]
        return {"vertices": vertices, "edges": edges}

    @staticmethod
    def _attempt_dict(a: Any) -> Dict[str, Any]:
        """The one serialization of an attempt row (shared by the task
        table and the drill-down)."""
        end = a.finish_time or clock.wall_s()
        return {
            "id": str(a.attempt_id), "state": a.state.name,
            "node": a.node_id or str(a.container_id or ""),
            "duration_s": round(max(0.0, end - a.launch_time), 2)
            if a.launch_time else 0.0,
        }

    @staticmethod
    def _tasks(am: Any, vertex_name: str) -> List[Dict[str, Any]]:
        dag = am.current_dag
        v = dag.vertex_by_name(vertex_name) if dag is not None else None
        if v is None:
            return []
        rows = []
        tasks = dict(v.tasks)
        for i in sorted(tasks):
            t = tasks[i]
            task_attempts = dict(t.attempts)
            attempts = [_Handler._attempt_dict(task_attempts[n])
                        for n in sorted(task_attempts)]
            rows.append({"index": i, "state": t.state.name,
                         "attempts": attempts})
        return rows

    @staticmethod
    def _counters(am: Any, vertex_name: str = "") -> Dict[str, Any]:
        """DAG-total counters, or one vertex's aggregation over its
        attempts' counters (tez-ui's per-vertex counters view)."""
        dag = am.current_dag
        if dag is None:
            return {}
        if not vertex_name:
            return dag.counters.to_dict()
        v = dag.vertex_by_name(vertex_name)
        if v is None:
            return {}
        from tez_tpu_torch.common.counters import TezCounters
        agg = TezCounters()
        for t in list(v.tasks.values()):
            # mirror the canonical roll-up (vertex_impl._finish_succeeded):
            # one attempt per task — the successful one when it exists,
            # else the latest — so retries never double-count I/O
            attempts = dict(t.attempts)
            if not attempts:
                continue
            chosen = next((a for a in attempts.values()
                           if a.state.name == "SUCCEEDED"),
                          attempts[max(attempts)])
            agg.aggregate(chosen.counters)
        return agg.to_dict()

    @staticmethod
    def _trace(am: Any) -> Dict[str, Any]:
        """Perfetto trace_event JSON: live span buffer when the tracing
        plane has recorded anything, else a post-mortem trace derived from
        history events (works even for a DAG traced by a crashed AM whose
        journal was replayed)."""
        from tez_tpu_torch.common import tracing
        from tez_tpu_torch.tools import trace_export
        spans = tracing.snapshot()
        if spans:
            return trace_export.spans_to_trace(spans)
        events = getattr(am.logging_service, "events", [])
        if events:
            from tez_tpu_torch.tools.history_parser import parse_history_events
            dags = parse_history_events(events)
            if dags:
                dag = dags[sorted(dags)[-1]]
                return trace_export.history_to_trace(dag)
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    @staticmethod
    def _metrics(am: Any, tenant: Optional[str] = None,
                 stream: Optional[str] = None) -> str:
        """Prometheus text scrape: process-global latency histograms +
        running-task/queued-fetch/epoch gauges + DAG counters, dynamic
        series names split into tenant=/stream=/lane= labels
        (obs/exposition.py); ?tenant= / ?stream= drill down."""
        from tez_tpu_torch.common import metrics
        # every live DAG contributes (concurrent session AM); an idle AM
        # falls back to the most recently retired DAG so post-completion
        # scrapes still see the final counters.  The registry snapshot is
        # taken under the AM's _dag_done lock: a DAG retiring between an
        # unlocked live_dags read and the fallback read could vanish from
        # BOTH maps mid-scrape and silently drop its counters.
        lock = getattr(am, "_dag_done", None)
        if lock is not None:
            with lock:
                dags = list(am.live_dags.values())
                if not dags:
                    dags = list(am.retired_dags.values())[-1:]
        else:
            dags = list(getattr(am, "live_dags", {}).values())
        if not dags and am.current_dag is not None:
            dags = [am.current_dag]
        running = 0
        counters_dict: Dict[str, Dict[str, int]] = {}
        if len(dags) == 1:
            counters_dict = dags[0].counters.to_dict()
        elif dags:
            from tez_tpu_torch.common.counters import TezCounters
            agg = TezCounters()
            for dag in dags:
                agg.aggregate(dag.counters)
            counters_dict = agg.to_dict()
        for dag in dags:
            for v in list(dag.vertices.values()):
                running += sum(1 for t in list(v.tasks.values())
                               if t.state.name == "RUNNING")
        gauges = metrics.registry().gauges()
        gauges["running_tasks"] = float(running)
        gauges["am_epoch"] = float(getattr(am, "attempt", 0) or 0)
        gauges.setdefault("shuffle.queued_fetches", 0.0)
        from tez_tpu_torch.obs import exposition
        return exposition.render_text(
            metrics.registry().histograms(), gauges, counters_dict,
            tenant=tenant, stream=stream)

    @staticmethod
    def _metrics_json(am: Any, tenant: Optional[str],
                      stream: Optional[str],
                      window_s: float) -> Dict[str, Any]:
        """GET /metrics.json: the same families as the text format plus
        windowed rate/p50/p95/p99 from the live rings and the telemetry
        plane's overflow accounting."""
        from tez_tpu_torch.common import metrics
        from tez_tpu_torch.obs import exposition, timeseries
        sampler = getattr(am, "telemetry", None)
        if not window_s:
            window_s = sampler.window_s if sampler is not None else 10.0
        reg = timeseries.registry()
        return exposition.render_json(
            metrics.registry().histograms(), metrics.registry().gauges(),
            windows=reg.windows(window_s), accounting=reg.accounting(),
            window_s=window_s, tenant=tenant, stream=stream)

    @staticmethod
    def _attempt(am: Any, attempt_id: str) -> Dict[str, Any]:
        """One attempt's full drill-down: counters, diagnostics, timing
        (tez-ui attempt page)."""
        dag = am.current_dag
        if dag is None:
            return {"error": "no DAG"}
        for v in list(dag.vertices.values()):
            for t in list(v.tasks.values()):
                for a in list(t.attempts.values()):
                    if str(a.attempt_id) != attempt_id:
                        continue
                    d = _Handler._attempt_dict(a)
                    d.update({
                        "vertex": v.name,
                        "launch_time": a.launch_time,
                        "finish_time": a.finish_time,
                        "diagnostics": list(a.diagnostics),
                        "counters": a.counters.to_dict(),
                    })
                    return d
        return {"error": f"unknown attempt {attempt_id}"}

    #: conf keys whose VALUES must never reach a browser
    _SECRET_MARKERS = ("token", "secret", "password", "ssl.key")

    @classmethod
    def _conf(cls, am: Any) -> Dict[str, Any]:
        """Effective DAG configuration (tez-ui configurations view),
        secrets redacted by key pattern."""
        dag = am.current_dag
        conf = getattr(dag, "conf", None) if dag is not None else am.conf
        if conf is None:
            return {}
        out = {}
        for k, v in dict(conf).items():
            lk = str(k).lower()
            out[k] = "<redacted>" if any(m in lk for m in
                                         cls._SECRET_MARKERS) else v
        return out

    def _parsed_dag(self, am: Any) -> Optional[Any]:
        """Parse the in-memory history into the latest DagInfo, cached on the
        event count — polling tabs must not re-parse an ever-growing event
        list on every request."""
        events = list(getattr(am.logging_service, "events", []))
        if not events:
            return None
        srv = self.server
        cached = getattr(srv, "_parse_cache", None)
        if cached is not None and cached[0] == len(events):
            return cached[1]
        from tez_tpu_torch.tools.history_parser import parse_history_events
        dags = parse_history_events(events)
        dag = list(dags.values())[-1] if dags else None
        srv._parse_cache = (len(events), dag)  # type: ignore[attr-defined]
        return dag

    def _analyzers(self, am: Any) -> List[Dict[str, Any]]:
        n_events = len(getattr(am.logging_service, "events", []))
        srv = self.server
        cached = getattr(srv, "_analyzer_cache", None)
        if cached is not None and cached[0] == n_events:
            return cached[1]
        dag = self._parsed_dag(am)
        if dag is None:
            return []
        from tez_tpu_torch.tools.analyzers import analyze_dag
        out = [r.to_dict() for r in analyze_dag(dag)]
        srv._analyzer_cache = (n_events, out)  # type: ignore[attr-defined]
        return out

    def _send(self, code: int, body: bytes,
              ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class WebUIService:
    def __init__(self, am: Any, host: str = "127.0.0.1", port: int = 0):
        self.am = am
        self._httpd = http.server.ThreadingHTTPServer((host, port), _Handler)
        self._httpd.am = am  # type: ignore[attr-defined]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="am-web")

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/"

    def start(self) -> "WebUIService":
        self._thread.start()
        log.info("AM web UI at %s", self.url)
        return self

    def stop(self) -> None:
        # shutdown() waits for serve_forever to return: on a service that
        # never started it would wait forever (tez_tpu's stop does)
        if self._thread.is_alive():
            self._httpd.shutdown()
        self._httpd.server_close()
