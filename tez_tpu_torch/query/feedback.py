"""Adaptive re-optimization: observed runs feed the next plan.

After every query run the session records, per logical node fingerprint:

- the physical choices the planner made (strategy, parallelism),
- the observed exchange sizes and per-partition byte histograms from the
  qstats side channel (tez.query.stats.dir, query/processors.py),
- the dominant blamed plane of the run — the doctor's plane attribution
  primitive (obs.timeseries.plane_for_name over the process histogram
  deltas, the same prefix->plane map tools/doctor.py sweeps with),
- wall-clock.

On the next plan of the same node, :meth:`PlanFeedback.advise_strategy`
flips an exchange-bound repartition join to broadcast once the observed
build side is known to fit ``tez.query.broadcast.max-mb`` (the static
estimator cannot see through a selective filter; the observation can),
flips a broadcast join whose build side outgrew the threshold back to
repartition, and :meth:`advise_reducers` doubles a skewed exchange's
parallelism (largest partition > skew-factor x the mean of the rest)
up to ``tez.query.replan.max-reducers``.  Every decision taken is journaled by
the session as a typed ``QUERY_REPLANNED`` summary event so the doctor
can blame the planner itself (docs/query.md, docs/doctor.md).

The port's copy of tez_tpu.query.feedback.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from tez_tpu_torch.common import config as C
from tez_tpu_torch.obs.timeseries import plane_for_name


def _get(conf: Any, key) -> Any:
    v = conf.get(key.name) if conf is not None else None
    return key.default if v is None else v


@dataclasses.dataclass
class ObservedNode:
    """What past runs taught us about one logical plan node."""
    strategy: str = ""           # physical strategy last used
    reducers: int = 0            # exchange parallelism last used
    #: role -> total observed bytes through that exchange
    bytes_by_role: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: role -> per-partition byte histogram (summed over tasks)
    partitions_by_role: Dict[str, List[int]] = \
        dataclasses.field(default_factory=dict)
    blamed: str = ""             # dominant plane of the last run
    wall_s: float = 0.0
    runs: int = 0


class PlanFeedback:
    """Per-session replan state; one instance lives on a QuerySession."""

    def __init__(self, conf: Any = None):
        self.enabled = bool(_get(conf, C.QUERY_REPLAN_ENABLED))
        self.skew_factor = float(_get(conf, C.QUERY_REPLAN_SKEW_FACTOR))
        self.max_reducers = int(_get(conf, C.QUERY_REPLAN_MAX_REDUCERS))
        self.nodes: Dict[str, ObservedNode] = {}

    # -- planner-facing advice -----------------------------------------

    def advise_strategy(self, fp: str, max_mb: float
                        ) -> Optional[Tuple[str, str, Dict[str, Any]]]:
        """-> (strategy, detail, journal-extras) or None (no opinion)."""
        obs = self.nodes.get(fp)
        if not self.enabled or obs is None or obs.runs == 0:
            return None
        build = obs.bytes_by_role.get("build")
        if build is None:
            return None
        build_mb = build / (1024.0 * 1024.0)
        extras = {"from": obs.strategy, "blamed": obs.blamed,
                  "observed_build_mb": round(build_mb, 3)}
        if obs.strategy == "repartition" and build_mb <= max_mb:
            # the static estimator mis-sized the build side (it cannot
            # see through a selective filter); the observation can.  An
            # exchange/transport-bound run 1 makes the case stronger,
            # but the observed fit alone already justifies the flip.
            bound = (f"run {obs.runs} was {obs.blamed}-bound and "
                     if obs.blamed in ("exchange", "transport") else
                     f"estimate miss (run {obs.runs} blamed "
                     f"{obs.blamed or 'n/a'}): ")
            extras["to"] = "broadcast"
            return ("broadcast",
                    f"{bound}the observed build side ({build_mb:.2f}MB) "
                    f"fits {max_mb}MB — flipping to broadcast", extras)
        if obs.strategy == "broadcast" and build_mb > max_mb:
            extras["to"] = "repartition"
            return ("repartition",
                    f"observed build side {build_mb:.2f}MB outgrew "
                    f"{max_mb}MB — flipping to repartition", extras)
        # stick with what worked; pin it so an estimate never flip-flops
        # a strategy observation already validated
        extras["to"] = obs.strategy
        return (obs.strategy,
                f"keeping observed-good {obs.strategy} "
                f"(build {build_mb:.2f}MB, blamed {obs.blamed or 'n/a'})",
                extras)

    def advise_reducers(self, fp: str, base: int
                        ) -> Optional[Tuple[int, str, Dict[str, Any]]]:
        obs = self.nodes.get(fp)
        if not self.enabled or obs is None or obs.runs == 0:
            return None
        current = obs.reducers or base
        for role, hist in sorted(obs.partitions_by_role.items()):
            if len(hist) < 2 or max(hist) <= 0:
                continue
            peak = max(hist)
            # skew = peak vs the mean of the OTHER partitions.  (peak vs
            # the overall mean is bounded by len(hist), so a factor >= 2
            # could never fire at 2 reducers no matter how skewed.)
            rest = (sum(hist) - peak) / float(len(hist) - 1)
            skewed = peak > self.skew_factor * rest if rest > 0 else True
            if skewed and current < self.max_reducers:
                bumped = min(current * 2, self.max_reducers)
                extras = {"from": current, "to": bumped, "role": role,
                          "peak_bytes": peak, "rest_bytes": round(rest, 1)}
                return (bumped,
                        f"{role} exchange skewed (peak {peak}B > "
                        f"{self.skew_factor}x rest-mean {rest:.0f}B) — "
                        f"reducers {current} -> {bumped}", extras)
        if current != base:
            # keep an earlier bump sticky across runs
            return (current, f"keeping replanned parallelism {current}",
                    {"from": current, "to": current})
        return None

    # -- session-facing recording --------------------------------------

    def record_run(self, decisions: List[Dict[str, Any]],
                   stats: Dict[Tuple[str, str], Dict[str, Any]],
                   blamed: str, wall_s: float) -> None:
        """``stats``: (node_fp, role) -> {"bytes": n, "partitions": [..]}
        aggregated from the qstats side channel by the session."""
        touched: Dict[str, ObservedNode] = {}
        for d in decisions:
            obs = self.nodes.setdefault(d["node"], ObservedNode())
            touched[d["node"]] = obs
            if d["kind"] == "join_strategy":
                obs.strategy = d["choice"]
            elif d["kind"] == "parallelism":
                obs.reducers = int(d["choice"])
        for (fp, role), s in stats.items():
            obs = self.nodes.setdefault(fp, ObservedNode())
            touched[fp] = obs
            obs.bytes_by_role[role] = int(s.get("bytes", 0))
            obs.partitions_by_role[role] = list(s.get("partitions", []))
        for obs in touched.values():
            obs.blamed = blamed
            obs.wall_s = wall_s
            obs.runs += 1


def blame_from_histograms(before: Dict[str, Any],
                          after: Dict[str, Any]) -> Tuple[str, float]:
    """Dominant plane of a run from process-histogram deltas: the
    doctor's prefix->plane attribution applied to the busy-ms each plane
    accumulated between two registry snapshots.  -> (plane, busy_ms);
    ('', 0.0) when nothing moved."""
    busy: Dict[str, float] = {}
    for name, h in after.items():
        plane = plane_for_name(name)
        if plane is None:
            continue
        prev = before.get(name)
        delta = h.sum_ms - (prev.sum_ms if prev is not None else 0.0)
        if delta > 0:
            busy[plane] = busy.get(plane, 0.0) + delta
    if not busy:
        return "", 0.0
    plane = max(sorted(busy), key=lambda p: busy[p])
    return plane, busy[plane]
