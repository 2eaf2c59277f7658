"""Cross-I/O memory arbitration for one task.

Reference parity: tez-runtime-internals/.../common/resources/
MemoryDistributor.java:110 + runtime-library WeightedScalingMemoryDistributor:
components request memory during initialize(), grants are scaled to fit the
task budget and delivered via callback before start().

TPU-first delta: the budget is an HBM byte budget per task (device memory is
the scarce resource the sorter/merger spans live in), not a JVM heap.

The port's copy of tez_tpu.runtime.memory.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, List, Optional

log = logging.getLogger(__name__)

#: Default per-task HBM budget used when the spec doesn't say (bytes).
DEFAULT_TASK_BUDGET = 2 << 30

#: Requests below this are granted in full before scaling (reference:
#: tez.task.scale.memory.reserve-fraction behavior approximated).
RESERVE_FRACTION = 0.05


#: Component-type weights for oversubscription scaling (reference:
#: WeightedScalingMemoryDistributor ratios — sorted outputs and merged
#: inputs get proportionally more than unsorted buffers).
DEFAULT_WEIGHTS = {
    "PARTITIONED_SORTED_OUTPUT": 3,
    "PARTITIONED_UNSORTED_OUTPUT": 1,
    "SORTED_MERGED_INPUT": 3,
    "UNSORTED_INPUT": 1,
    "PROCESSOR": 1,
    "OTHER": 1,
}


@dataclasses.dataclass
class _Request:
    requester: str
    requested: int
    callback: Optional[Callable[[int], None]]
    component_type: str = "OTHER"
    granted: int = 0


def parse_weight_ratios(spec: str) -> Optional[dict]:
    """Parse 'TYPE=WEIGHT,...' overrides (reference format:
    tez.task.scale.memory.ratios, WeightedScalingMemoryDistributor
    .populateTypeScaleMap).  Unknown types are accepted (custom component
    types weight themselves); malformed specs return None and the caller
    keeps the defaults."""
    if not spec:
        return None
    out = dict(DEFAULT_WEIGHTS)
    try:
        for part in spec.split(","):
            name, _, w = part.strip().partition("=")
            if not name or not w:
                return None
            out[name.strip()] = int(w)
    except ValueError:
        return None
    return out


class MemoryDistributor:
    def __init__(self, budget_bytes: int = DEFAULT_TASK_BUDGET,
                 weights: Optional[dict] = None,
                 reserve_fraction: float = RESERVE_FRACTION,
                 weighted: bool = True):
        reserve_fraction = min(max(float(reserve_fraction), 0.0), 1.0)
        self.budget = int(budget_bytes * (1 - reserve_fraction))
        # weighted=False: uniform scaling (reference ScalingAllocator —
        # every component type scales by the same factor)
        self.weights = (weights or DEFAULT_WEIGHTS) if weighted \
            else {k: 1 for k in DEFAULT_WEIGHTS}
        self._weighted = weighted
        self._requests: List[_Request] = []
        self._allocated = False

    def request_memory(self, size: int, callback: Optional[Callable[[int], None]],
                       requester: str = "",
                       component_type: str = "OTHER") -> None:
        assert not self._allocated, "requests closed after allocation"
        self._requests.append(_Request(requester, int(size), callback,
                                       component_type))

    def make_initial_allocations(self) -> None:
        """Scale requests to fit the budget when oversubscribed, weighted by
        component type (reference: MemoryDistributor.makeInitialAllocations
        :120 + WeightedScalingMemoryDistributor)."""
        total = sum(r.requested for r in self._requests)
        if total <= self.budget or total == 0:
            for r in self._requests:
                r.granted = r.requested
                if r.callback is not None:
                    r.callback(r.granted)
            self._allocated = True
            return
        # oversubscribed: shuffle data the buffer store holds in host RAM
        # competes with the buffers the scaled-down components are about to
        # allocate — demote idle store entries toward disk by the shortfall
        # before squeezing the task's own grants
        try:
            from tez_tpu_torch.store import local_buffer_store
            store = local_buffer_store()
            if store is not None:
                freed = store.relieve_host_pressure(total - self.budget)
                if freed:
                    log.info("memory oversubscribed by %d bytes: store "
                             "demoted %d bytes to disk",
                             total - self.budget, freed)
        except Exception:  # noqa: BLE001 — relief is best-effort
            log.exception("buffer-store pressure relief failed")
        weighted = [(r, self.weights.get(r.component_type, 1))
                    for r in self._requests]
        # iterative weighted fill: capped requests release their surplus to
        # the still-unmet ones (few components per task, so 2-3 rounds)
        remaining = self.budget
        pending = list(weighted)
        grants = {id(r): 0 for r, _ in weighted}
        while pending and remaining > 0:
            total_weight = sum(w * (r.requested - grants[id(r)])
                               for r, w in pending)
            if total_weight <= 0:
                break
            next_pending = []
            progressed = False
            for r, w in pending:
                need = r.requested - grants[id(r)]
                share = int(remaining * (w * need) / total_weight)
                give = min(need, share)
                if give > 0:
                    grants[id(r)] += give
                    progressed = True
                if grants[id(r)] < r.requested:
                    next_pending.append((r, w))
            spent = sum(grants.values())
            remaining = self.budget - spent
            if not progressed:
                break
            pending = next_pending
        for r, _ in weighted:
            r.granted = grants[id(r)]
            if r.callback is not None:
                r.callback(r.granted)
        self._allocated = True
        log.info("memory oversubscribed: weighted-scaled %d requests "
                 "(asked %d, budget %d)", len(self._requests), total,
                 self.budget)

    def total_granted(self) -> int:
        return sum(r.granted for r in self._requests)
