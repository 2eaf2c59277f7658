"""Render a runner/attempt swimlane SVG from history.

Reference parity: tez-tools/swimlanes/*.py (container-timeline SVG from ATS).
Usage: python -m tez_tpu_torch.tools.swimlane <history.jsonl...> [-o out.svg]

The port's copy of tez_tpu.tools.swimlane.
"""
from __future__ import annotations

import sys
from typing import Dict, List

from tez_tpu_torch.tools.history_parser import DagInfo, parse_jsonl_files

LANE_H = 22
LEFT = 180
PX_PER_S = 120.0

_COLORS = ["#4e79a7", "#f28e2b", "#59a14f", "#e15759", "#76b7b2", "#edc948",
           "#b07aa1", "#ff9da7", "#9c755f", "#bab0ac"]


def render_svg(dag: DagInfo) -> str:
    attempts = [a for a in dag.all_attempts() if a.start_time]
    lanes: Dict[str, List] = {}
    for a in attempts:
        lanes.setdefault(a.container_id or "?", []).append(a)
    t0 = dag.start_time or min((a.start_time for a in attempts), default=0)
    t1 = max([dag.finish_time] + [a.finish_time for a in attempts] + [t0])
    width = LEFT + int((t1 - t0) * PX_PER_S) + 40
    height = (len(lanes) + 2) * LANE_H + 40
    vertex_names = sorted({a.vertex_name for a in attempts})
    color = {v: _COLORS[i % len(_COLORS)]
             for i, v in enumerate(vertex_names)}

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="monospace" font-size="11">',
        f'<text x="4" y="14">{dag.name} ({dag.state}) '
        f'{dag.duration:.2f}s</text>']
    y = 30
    for cid in sorted(lanes):
        parts.append(f'<text x="4" y="{y + 14}">{cid[-18:]}</text>')
        for a in sorted(lanes[cid], key=lambda a: a.start_time):
            x = LEFT + (a.start_time - t0) * PX_PER_S
            w = max(2.0, (max(a.finish_time, a.start_time) - a.start_time)
                    * PX_PER_S)
            c = color.get(a.vertex_name, "#999")
            dash = ' stroke="#c00" stroke-width="2"' if a.state != "SUCCEEDED" \
                else ""
            parts.append(
                f'<rect x="{x:.1f}" y="{y + 2}" width="{w:.1f}" '
                f'height="{LANE_H - 6}" fill="{c}"{dash}>'
                f'<title>{a.attempt_id} [{a.state}] '
                f'{a.duration:.2f}s</title></rect>')
        y += LANE_H
    # legend
    x = LEFT
    for v in vertex_names:
        parts.append(f'<rect x="{x}" y="{y + 4}" width="10" height="10" '
                     f'fill="{color[v]}"/>')
        parts.append(f'<text x="{x + 14}" y="{y + 13}">{v}</text>')
        x += 14 + 8 * len(v) + 20
    parts.append("</svg>")
    return "\n".join(parts)


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "-o"]
    out = None
    if "-o" in sys.argv:
        out = sys.argv[sys.argv.index("-o") + 1]
        args.remove(out)
    if not args:
        print("usage: swimlane <history.jsonl...> [-o out.svg]")
        return 2
    dags = parse_jsonl_files(args)
    if not dags:
        print("no DAGs found")
        return 1
    dag = list(dags.values())[-1]
    svg = render_svg(dag)
    if out:
        with open(out, "w") as fh:
            fh.write(svg)
        print(f"wrote {out}")
    else:
        print(svg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
