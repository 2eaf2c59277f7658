"""graft top: a refreshing terminal view of one live AM.

Scrapes ``GET /doctor/live`` (and nothing else — one request per frame)
off the AM web UI and renders the continuous doctor in place: per-plane
blame bars over the sliding window, admission queue depth, per-tenant
running/queued counts, per-stream commit/lag/latency, mesh lane
occupancy, and any active SLO breach or burn alert.  Curses-free on
purpose: plain ANSI (cursor-home + erase-down), so it works in any
terminal, under ``script``, and inside CI logs.

CLI (also ``make top URL=http://127.0.0.1:PORT``):
  python -m tez_tpu_torch.tools.top URL [--window S] [--interval S] [--once]

``--once`` prints a single frame without ANSI control codes and exits —
what the metrics-smoke test and docs examples use.  The AM must run
with ``tez.am.web.enabled=true`` (the soak harness does); the URL is
printed in the AM log line ``AM web UI at ...``.

Rendering is a pure function of the ``/doctor/live`` JSON payload
(:func:`render`), so tests feed it canned payloads without a socket.
See docs/telemetry.md.

The port's copy of tez_tpu.tools.top.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

#: ANSI: home the cursor and erase to end of screen — repaint without
#: scrollback spam (unlike a full 2J clear, no flicker on slow TTYs)
_REPAINT = "\x1b[H\x1b[J"

_BAR_W = 24


def _bar(frac: float, width: int = _BAR_W) -> str:
    frac = max(0.0, min(1.0, frac))
    n = int(round(frac * width))
    return "█" * n + "░" * (width - n)


def fetch(base_url: str, window_s: Optional[float] = None,
          timeout: float = 5.0) -> Dict[str, Any]:
    """One ``/doctor/live`` scrape; raises URLError/ValueError on junk."""
    url = base_url.rstrip("/") + "/doctor/live"
    if window_s:
        url += f"?window={window_s:g}"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def render(status: Dict[str, Any], width: int = 78) -> str:
    """The frame, as plain text — pure function of the live payload."""
    L: List[str] = []
    win = status.get("window_s", 0)
    samp = status.get("sampler", {})
    L.append(f"== graft top ==  window {win:g}s  "
             f"sampler {'on' if samp.get('enabled') else 'OFF'} "
             f"({samp.get('ticks', 0)} ticks, "
             f"period {samp.get('period_s', 0):g}s)")

    planes = status.get("planes", {})
    busy = planes.get("busy_ms", {}) or {}
    total = sum(busy.values())
    L.append("")
    L.append(f"plane blame (instrumented busy over the window"
             + (f", dominant: {planes['dominant']}"
                if planes.get("dominant") else "") + "):")
    if total > 0:
        for p, ms in sorted(busy.items(), key=lambda kv: -kv[1]):
            if ms <= 0:
                continue
            L.append(f"  {p:<10} {_bar(ms / total)} "
                     f"{100.0 * ms / total:6.2f}%  {ms:9.1f} ms")
    else:
        L.append("  (no instrumented activity in the window)")

    qd = status.get("queue_depth")
    if qd is not None:
        L.append("")
        L.append(f"admission: queue depth {qd}, "
                 f"{status.get('running_dags', 0)} running DAG(s)")
    tenants = status.get("tenants") or {}
    if tenants:
        L.append("tenants:")
        for name, t in sorted(tenants.items()):
            if isinstance(t, dict):
                detail = "  ".join(f"{k}={v}" for k, v in sorted(t.items())
                                   if isinstance(v, (int, float, str)))
            else:
                detail = str(t)
            L.append(f"  {name:<12} {detail}"[:width])

    streams = status.get("streams") or {}
    if streams:
        L.append("")
        L.append("streams:")
        for name, st in sorted(streams.items()):
            parts = [f"{name:<12}"]
            for k in ("state", "committed", "replayed", "lag"):
                if k in st:
                    parts.append(f"{k}={st[k]}")
            wl = st.get("window_latency")
            if wl and wl.get("count"):
                parts.append(f"p95={wl.get('p95_ms', 0):.0f}ms")
                parts.append(f"rate={wl.get('rate_per_s', 0):.2f}/s")
            L.append(("  " + " ".join(str(p) for p in parts))[:width])

    lanes = status.get("lanes") or {}
    if lanes:
        L.append("")
        L.append("mesh lanes (occupancy):")
        for lane, occ in sorted(lanes.items(), key=lambda kv: kv[0]):
            L.append(f"  lane {lane:>3} {_bar(float(occ))} "
                     f"{100.0 * float(occ):6.2f}%")

    slo = status.get("slo") or {}
    breaches = slo.get("breaches") or []
    burns = slo.get("burn") or []
    if breaches or burns:
        L.append("")
        for b in burns:
            where = (f"stream={b['stream']}" if b.get("stream")
                     else f"tenant={b.get('tenant', '?')}")
            L.append(f"  BURN   {where} {b.get('kind', '?')} "
                     f"observed={b.get('observed', '?')} "
                     f"target={b.get('target', '?')}")
        for b in breaches:
            where = (f"stream={b['stream']}" if b.get("stream")
                     else f"tenant={b.get('tenant', '?')}")
            L.append(f"  BREACH {where} {b.get('kind', '?')} "
                     f"observed={b.get('observed', '?')} "
                     f"target={b.get('target', '?')}")
    else:
        L.append("")
        L.append("slo: clean (no active breach or burn alert)")

    acct = status.get("accounting") or {}
    flagged = {k: v for k, v in acct.items()
               if k in ("evicted", "collector_errors", "scrape_errors")
               and v}
    L.append("")
    L.append("rings: " + (", ".join(f"{k}={v}"
                                    for k, v in sorted(flagged.items()))
                          if flagged else "healthy")
             + f"  ({acct.get('series', 0)} series)")
    return "\n".join(L)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Live terminal view of one AM's /doctor/live "
                    "(see docs/telemetry.md)")
    ap.add_argument("url", help="AM web UI base URL, e.g. "
                                "http://127.0.0.1:8080")
    ap.add_argument("--window", type=float, default=0.0,
                    help="aggregation window seconds "
                         "(default: the AM's tez.am.metrics.window-s)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="print one frame without ANSI codes and exit")
    args = ap.parse_args(argv)

    while True:
        try:
            status = fetch(args.url, args.window or None)
        except (urllib.error.URLError, OSError, ValueError) as e:
            print(f"graft top: cannot scrape {args.url}: {e}",
                  file=sys.stderr)
            return 1
        frame = render(status)
        if args.once:
            print(frame)
            return 0
        sys.stdout.write(_REPAINT + frame + "\n")
        sys.stdout.flush()
        try:
            time.sleep(max(0.2, args.interval))
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
