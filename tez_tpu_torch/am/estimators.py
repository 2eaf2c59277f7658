"""Task-runtime estimators behind the speculation SPI.

Reference parity: tez-dag/.../dag/speculation/legacy/TaskRuntimeEstimator.java:56
(estimator contract), LegacyTaskRuntimeEstimator.java (progress-rate estimate
over start/end statistics), SimpleExponentialTaskRuntimeEstimator.java +
forecast/SimpleExponentialSmoothing.java (exponentially-smoothed progress
rate with stagnation detection), DataStatistics.java (mean/std/outlier).

The estimator is selected per vertex via ``tez.am.legacy.speculative.
estimator.class`` — a registry shorthand ("legacy", "simple_exponential")
or a fully-qualified class path.

The port's copy of tez_tpu.am.estimators.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional

from tez_tpu_torch.common import config as C


class DataStatistics:
    """Streaming mean/variance of completed-attempt durations
    (reference: DataStatistics.java)."""

    def __init__(self) -> None:
        self.count = 0
        self._sum = 0.0
        self._sumsq = 0.0

    def add(self, x: float) -> None:
        self.count += 1
        self._sum += x
        self._sumsq += x * x

    def mean(self) -> float:
        return self._sum / self.count if self.count else 0.0

    def var(self) -> float:
        if self.count <= 1:
            return 0.0
        m = self.mean()
        return max(0.0, self._sumsq / self.count - m * m)

    def std(self) -> float:
        return math.sqrt(self.var())

    def outlier(self, sigma: float) -> float:
        """Runtime above which an attempt counts as an outlier."""
        return self.mean() + self.std() * sigma


class TaskRuntimeEstimator:
    """SPI: per-vertex estimator the speculator consults
    (reference: TaskRuntimeEstimator.java:56)."""

    def contextualize(self, conf, vertex_name: str) -> None:
        self.conf = conf
        self.vertex_name = vertex_name

    def enroll(self, attempt_id: str, launch_time: float) -> None:
        """A new attempt started running."""
        raise NotImplementedError

    def update_attempt(self, attempt_id: str, progress: float,
                       timestamp: float) -> None:
        """A progress report arrived for a running attempt."""
        raise NotImplementedError

    def attempt_succeeded(self, duration: float) -> None:
        """A sibling attempt in this vertex completed in ``duration``s."""
        raise NotImplementedError

    def estimated_runtime(self, attempt_id: str,
                          now: float) -> Optional[float]:
        """Estimated TOTAL runtime (seconds since launch) of the attempt, or
        None when no estimate is possible yet."""
        raise NotImplementedError

    def estimated_new_attempt_runtime(self) -> Optional[float]:
        """Expected runtime of a freshly launched replacement attempt."""
        raise NotImplementedError

    def threshold_runtime(self, sigma: float) -> Optional[float]:
        """Runtime beyond which an attempt is a statistical straggler."""
        raise NotImplementedError

    def has_stagnated(self, attempt_id: str, now: float) -> bool:
        """True when the attempt stopped making progress entirely."""
        return False


class StartEndTimesBase(TaskRuntimeEstimator):
    """Shared bookkeeping: launch times + completed-duration statistics
    (reference: StartEndTimesBase.java)."""

    def __init__(self) -> None:
        self.launch_times: Dict[str, float] = {}
        self.stats = DataStatistics()

    def enroll(self, attempt_id: str, launch_time: float) -> None:
        self.launch_times.setdefault(attempt_id, launch_time)

    def attempt_succeeded(self, duration: float) -> None:
        self.stats.add(duration)

    def estimated_new_attempt_runtime(self) -> Optional[float]:
        if self.stats.count == 0:
            return None
        return self.stats.mean()

    def threshold_runtime(self, sigma: float) -> Optional[float]:
        if self.stats.count == 0:
            return None
        return self.stats.outlier(sigma)

    def forget(self, attempt_id: str) -> None:
        self.launch_times.pop(attempt_id, None)


class LegacyRuntimeEstimator(StartEndTimesBase):
    """Whole-lifetime progress rate: estimate = elapsed / progress
    (reference: LegacyTaskRuntimeEstimator.java)."""

    def __init__(self) -> None:
        super().__init__()
        self._progress: Dict[str, float] = {}

    def update_attempt(self, attempt_id: str, progress: float,
                       timestamp: float) -> None:
        self._progress[attempt_id] = progress

    def forget(self, attempt_id: str) -> None:
        super().forget(attempt_id)
        self._progress.pop(attempt_id, None)

    def estimated_runtime(self, attempt_id: str,
                          now: float) -> Optional[float]:
        launch = self.launch_times.get(attempt_id)
        if launch is None:
            return None
        elapsed = now - launch
        progress = max(self._progress.get(attempt_id, 0.0), 1e-6)
        return elapsed / progress


class _Smoothing:
    """Exponentially-smoothed progress RATE for one attempt (reference:
    forecast/SimpleExponentialSmoothing.java — alpha = 1 - exp(-dt/lambda),
    so old samples decay with a fixed time constant regardless of report
    cadence)."""

    def __init__(self, time_constant: float):
        self.time_constant = max(time_constant, 1e-3)
        self.samples = 0
        self.rate: Optional[float] = None
        self.last_progress = 0.0
        self.last_time: Optional[float] = None
        self.last_change_time: Optional[float] = None

    def update(self, progress: float, timestamp: float) -> None:
        if self.last_time is None:
            self.last_time = timestamp
            self.last_progress = progress
            self.last_change_time = timestamp
            return
        dt = timestamp - self.last_time
        if dt <= 0:
            return
        if progress > self.last_progress:
            self.last_change_time = timestamp
        raw = max(progress - self.last_progress, 0.0) / dt
        alpha = 1.0 - math.exp(-dt / self.time_constant)
        self.rate = raw if self.rate is None else \
            alpha * raw + (1.0 - alpha) * self.rate
        self.samples += 1
        self.last_time = timestamp
        self.last_progress = progress


class SimpleExponentialRuntimeEstimator(StartEndTimesBase):
    """Forecasts remaining time from the smoothed RECENT progress rate, so a
    task that started slowly but is now moving is not condemned by its
    lifetime average — and a stagnated task is, even if its average looks
    healthy (reference: SimpleExponentialTaskRuntimeEstimator.java:113-134)."""

    def __init__(self) -> None:
        super().__init__()
        self._smooth: Dict[str, _Smoothing] = {}

    def contextualize(self, conf, vertex_name: str) -> None:
        super().contextualize(conf, vertex_name)
        self.time_constant = conf.get(C.SPECULATION_SMOOTH_LAMBDA_MS) / 1e3
        self.stagnated_window = conf.get(C.SPECULATION_STAGNATED_MS) / 1e3
        self.skip_initials = conf.get(C.SPECULATION_SKIP_INITIALS)

    def update_attempt(self, attempt_id: str, progress: float,
                       timestamp: float) -> None:
        sm = self._smooth.get(attempt_id)
        if sm is None:
            sm = self._smooth[attempt_id] = _Smoothing(self.time_constant)
        sm.update(progress, timestamp)

    def forget(self, attempt_id: str) -> None:
        super().forget(attempt_id)
        self._smooth.pop(attempt_id, None)

    def has_stagnated(self, attempt_id: str, now: float) -> bool:
        sm = self._smooth.get(attempt_id)
        if sm is None or sm.last_change_time is None:
            return False
        return (now - sm.last_change_time) > self.stagnated_window

    def estimated_runtime(self, attempt_id: str,
                          now: float) -> Optional[float]:
        launch = self.launch_times.get(attempt_id)
        sm = self._smooth.get(attempt_id)
        if launch is None or sm is None:
            return None
        if self.has_stagnated(attempt_id, now):
            return math.inf
        if sm.rate is None or sm.samples < self.skip_initials:
            return None   # not enough signal yet — don't condemn early
        elapsed = now - launch
        remaining = max(1.0 - sm.last_progress, 0.0)
        rate = max(sm.rate, 1e-10)
        return elapsed + remaining / rate


_REGISTRY = {
    "legacy": LegacyRuntimeEstimator,
    "simple_exponential": SimpleExponentialRuntimeEstimator,
}


def create_estimator(conf, vertex_name: str) -> TaskRuntimeEstimator:
    name = conf.get(C.SPECULATION_ESTIMATOR)
    cls = _REGISTRY.get(name)
    if cls is None:
        from tez_tpu_torch.common.payload import resolve_class
        cls = resolve_class(name)
    est = cls()
    est.contextualize(conf, vertex_name)
    return est
