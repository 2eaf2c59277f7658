"""Metrics exposition: label-aware Prometheus text + structured JSON.

``common/metrics.py`` keeps series under *flat dynamic names* —
``tenant.<t>.dag.latency``, ``stream.<s>.window.latency``,
``mesh.lane.<i>.occupancy`` — because the hot path must not allocate
label dicts.  This module is where those names become labels: at scrape
time (cold path, one caller) each name is split into a base family plus
``tenant=`` / ``stream=`` / ``lane=`` labels, so one dashboard query
aggregates across tenants instead of matching a regex over metric names,
and ``GET /metrics?tenant=a`` serves a per-tenant drill-down without the
planes ever knowing labels exist.

Rendering is deterministic by construction — families sorted by name,
label sets sorted by label items, no timestamps in the text format — so
the exposition is golden-testable byte-for-byte (tests/golden/).
:func:`parse_exposition` is the other half of that contract: the strict
parser the golden test and ``make metrics-smoke`` run against a live
scrape, validating label escaping, cumulative bucket monotonicity and
count/sum consistency.  See docs/telemetry.md.

The port's copy of tez_tpu.obs.exposition.  The port serves no web UI yet,
so the text and JSON bodies are built by whoever scrapes the registry
(tests, chip_smoke.py) rather than by ``GET /metrics``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

from tez_tpu_torch.common.metrics import (BUCKET_BOUNDS_MS, HIST_GROUP_PREFIX,
                                    Histogram, _escape_label, _sanitize,
                                    quantile_from_buckets)

#: ``stream.window.*`` is the session-wide aggregate family the
#: StreamDriver always feeds; every OTHER ``stream.<x>.…`` name is a
#: per-stream series (a stream literally named "window" would collide —
#: the StreamDriver rejects it at open_stream).
_STREAM_AGGREGATE_SEGMENT = "window"


def split_labels(name: str) -> Tuple[str, Dict[str, str]]:
    """Flat dynamic series name -> (base family, labels)."""
    parts = name.split(".")
    if parts[0] == "tenant" and len(parts) >= 3:
        return "tenant." + ".".join(parts[2:]), {"tenant": parts[1]}
    if parts[0] == "stream" and len(parts) >= 3 \
            and parts[1] != _STREAM_AGGREGATE_SEGMENT:
        return "stream." + ".".join(parts[2:]), {"stream": parts[1]}
    if parts[0] == "mesh" and len(parts) >= 4 and parts[1] == "lane":
        return "mesh.lane." + ".".join(parts[3:]), {"lane": parts[2]}
    return name, {}


def _keep(labels: Dict[str, str], tenant: Optional[str],
          stream: Optional[str]) -> bool:
    """Drill-down filter: a tenant= / stream= query keeps only the series
    carrying that label value."""
    if tenant is not None and labels.get("tenant") != tenant:
        return False
    if stream is not None and labels.get("stream") != stream:
        return False
    return True


def _label_str(labels: Mapping[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"'
             for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


# --------------------------------------------------------------------------
# Prometheus text (version 0.0.4), label-aware
# --------------------------------------------------------------------------

def render_text(histograms: Mapping[str, Histogram],
                gauges: Mapping[str, float],
                counters_dict: Optional[Mapping[str,
                                                Mapping[str, int]]] = None,
                tenant: Optional[str] = None,
                stream: Optional[str] = None) -> str:
    """The GET /metrics body: every histogram family with cumulative
    le-buckets, every gauge, every plain counter — dynamic names split
    into labels, everything sorted, nothing time-dependent beyond the
    sampled values themselves."""
    filtering = tenant is not None or stream is not None
    hist_fams: Dict[str, List[Tuple[Dict[str, str], Histogram]]] = {}
    for name in histograms:
        base, labels = split_labels(name)
        if not _keep(labels, tenant, stream):
            continue
        hist_fams.setdefault(base, []).append((labels, histograms[name]))
    gauge_fams: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for name in gauges:
        base, labels = split_labels(name)
        if not _keep(labels, tenant, stream):
            continue
        gauge_fams.setdefault(base, []).append((labels, gauges[name]))

    lines: List[str] = []
    for base in sorted(hist_fams):
        metric = f"tez_latency_{_sanitize(base)}_ms"
        lines.append(f"# HELP {metric} latency histogram for {base}")
        lines.append(f"# TYPE {metric} histogram")
        for labels, h in sorted(hist_fams[base],
                                key=lambda lh: sorted(lh[0].items())):
            cum = 0
            for i, bound in enumerate(BUCKET_BOUNDS_MS):
                cum += h.counts[i]
                le = 'le="%g"' % bound
                lines.append(
                    f"{metric}_bucket{_label_str(labels, le)} {cum}")
            cum += h.counts[-1]
            inf = 'le="+Inf"'
            lines.append(
                f"{metric}_bucket{_label_str(labels, inf)} {cum}")
            lines.append(f"{metric}_sum{_label_str(labels)} {h.sum_ms:g}")
            lines.append(f"{metric}_count{_label_str(labels)} {h.count}")
    for base in sorted(gauge_fams):
        metric = f"tez_{_sanitize(base)}"
        lines.append(f"# TYPE {metric} gauge")
        for labels, v in sorted(gauge_fams[base],
                                key=lambda lv: sorted(lv[0].items())):
            lines.append(f"{metric}{_label_str(labels)} {v:g}")
    if counters_dict and not filtering:
        lines.append("# HELP tez_counter Tez counter value")
        lines.append("# TYPE tez_counter gauge")
        for gname in sorted(counters_dict):
            if gname.startswith(HIST_GROUP_PREFIX):
                continue          # rendered as histogram families above
            for cname in sorted(counters_dict[gname]):
                lines.append(
                    f'tez_counter{{group="{_escape_label(gname)}",'
                    f'name="{_escape_label(cname)}"}} '
                    f"{counters_dict[gname][cname]}")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# Structured JSON (GET /metrics.json)
# --------------------------------------------------------------------------

def render_json(histograms: Mapping[str, Histogram],
                gauges: Mapping[str, float],
                windows: Optional[Mapping[str, Dict[str, Any]]] = None,
                accounting: Optional[Mapping[str, int]] = None,
                window_s: float = 0.0,
                tenant: Optional[str] = None,
                stream: Optional[str] = None) -> Dict[str, Any]:
    """The GET /metrics.json body: the same families as the text format
    plus derived quantiles, the windowed aggregates the time-series
    registry computed (when given), and the telemetry plane's own
    overflow accounting."""
    hist_rows: List[Dict[str, Any]] = []
    for name in sorted(histograms):
        base, labels = split_labels(name)
        if not _keep(labels, tenant, stream):
            continue
        h = histograms[name]
        row: Dict[str, Any] = {
            "name": base, "labels": labels, "series": name,
            "count": h.count, "sum_ms": round(h.sum_ms, 4),
            "p50": round(quantile_from_buckets(h.counts, 0.50), 4),
            "p95": round(quantile_from_buckets(h.counts, 0.95), 4),
            "p99": round(quantile_from_buckets(h.counts, 0.99), 4),
        }
        if windows is not None and name in windows and windows[name]:
            row["window"] = windows[name]
        hist_rows.append(row)
    gauge_rows: List[Dict[str, Any]] = []
    for name in sorted(gauges):
        base, labels = split_labels(name)
        if not _keep(labels, tenant, stream):
            continue
        row = {"name": base, "labels": labels, "series": name,
               "value": gauges[name]}
        if windows is not None and name in windows and windows[name]:
            row["window"] = windows[name]
        gauge_rows.append(row)
    out: Dict[str, Any] = {"histograms": hist_rows, "gauges": gauge_rows}
    if window_s:
        out["window_s"] = window_s
    if accounting is not None:
        out["accounting"] = dict(accounting)
    return out


# --------------------------------------------------------------------------
# The golden parser (tests/golden + make metrics-smoke)
# --------------------------------------------------------------------------

def _parse_labels(raw: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    i = 0
    while i < len(raw):
        eq = raw.index("=", i)
        key = raw[i:eq]
        if raw[eq + 1] != '"':
            raise ValueError(f"unquoted label value after {key!r}")
        j = eq + 2
        val: List[str] = []
        while True:
            ch = raw[j]
            if ch == "\\":
                nxt = raw[j + 1]
                val.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
            elif ch == '"':
                break
            else:
                val.append(ch)
                j += 1
        labels[key] = "".join(val)
        i = j + 1
        if i < len(raw) and raw[i] == ",":
            i += 1
    return labels


def parse_exposition(text: str) -> Dict[str, Dict[str, Any]]:
    """Strictly parse a Prometheus 0.0.4 text body into
    ``{family: {"type": str, "samples": [(name, labels, value)]}}``,
    validating the invariants the golden test and metrics-smoke rely on:
    every sample's family was TYPE-declared, every histogram's le-buckets
    are cumulative (non-decreasing, ending at ``+Inf`` == ``_count``),
    and label values round-trip the escaping rules.  Raises ValueError on
    the first violation."""
    fams: Dict[str, Dict[str, Any]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            fam, _, ftype = rest.partition(" ")
            if fam in fams:
                raise ValueError(f"line {lineno}: duplicate TYPE for {fam}")
            fams[fam] = {"type": ftype.strip(), "samples": []}
            continue
        if line.startswith("#"):
            continue
        brace = line.find("{")
        if brace >= 0:
            name = line[:brace]
            close = line.rindex("}")
            labels = _parse_labels(line[brace + 1:close])
            value_str = line[close + 1:].strip()
        else:
            name, _, value_str = line.partition(" ")
            labels = {}
        try:
            value = float(value_str)
        except ValueError:
            raise ValueError(
                f"line {lineno}: unparsable value {value_str!r}") from None
        fam = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in fams:
                fam = name[:-len(suffix)]
                break
        if fam not in fams:
            raise ValueError(f"line {lineno}: sample {name} has no TYPE")
        fams[fam]["samples"].append((name, labels, value))
    # histogram invariants: per label set, buckets cumulative + consistent
    for fam, info in fams.items():
        if info["type"] != "histogram":
            continue
        by_labelset: Dict[Tuple, Dict[str, Any]] = {}
        for name, labels, value in info["samples"]:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            slot = by_labelset.setdefault(
                key, {"buckets": [], "sum": None, "count": None})
            if name.endswith("_bucket"):
                slot["buckets"].append((labels.get("le", ""), value))
            elif name.endswith("_sum"):
                slot["sum"] = value
            elif name.endswith("_count"):
                slot["count"] = value
        for key, slot in by_labelset.items():
            buckets = slot["buckets"]
            if not buckets or buckets[-1][0] != "+Inf":
                raise ValueError(f"{fam}{dict(key)}: no terminal +Inf bucket")
            values = [v for _, v in buckets]
            if any(b > a for b, a in zip(values, values[1:])):
                raise ValueError(f"{fam}{dict(key)}: buckets not cumulative")
            if slot["count"] is None or slot["sum"] is None:
                raise ValueError(f"{fam}{dict(key)}: missing _count/_sum")
            if slot["count"] != values[-1]:
                raise ValueError(
                    f"{fam}{dict(key)}: _count {slot['count']} != +Inf "
                    f"bucket {values[-1]}")
    return fams
