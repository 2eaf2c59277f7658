"""Typed configuration with scope annotations.

Reference parity: tez-api/.../TezConfiguration.java (238 keys,
@ConfigurationScope annotations) and TezRuntimeConfiguration.java (70 runtime
keys filtered into per-IO payloads via the edge config builders).  The design
rule kept from the reference: *runtime config travels inside the edge payload,
not global files* (SURVEY.md §5.6).

TPU-first deltas: memory keys budget HBM instead of JVM heap; sorter/shuffle
keys configure device kernels (span bytes = HBM block size, io factor = k-way
merge width on device).

The port's copy of tez_tpu.common.config.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Iterator, Mapping


_UNSET = object()


class Scope(enum.Enum):
    """Reference: ConfigurationScope.java — where a key may be overridden."""
    AM = "am"
    DAG = "dag"
    VERTEX = "vertex"
    CLIENT = "client"


@dataclasses.dataclass(frozen=True)
class ConfKey:
    name: str
    default: Any
    scope: Scope
    doc: str = ""

    def __call__(self, conf: "TezConfiguration") -> Any:
        return conf.get(self)


_REGISTRY: dict[str, ConfKey] = {}


def _key(name: str, default: Any, scope: Scope, doc: str = "") -> ConfKey:
    k = ConfKey(name, default, scope, doc)
    _REGISTRY[name] = k
    return k


class TezConfiguration(dict):
    """String-keyed config map with typed accessors.

    Mirrors Hadoop `Configuration` usage in the reference but is a plain dict
    so it pickles into payloads cheaply.
    """

    def get_key(self, key: "ConfKey | str", default: Any = _UNSET) -> Any:
        return self.get(key, default)

    def get(self, key: Any, default: Any = _UNSET) -> Any:  # type: ignore[override]
        """Precedence: stored value > caller-supplied default > registered
        ConfKey default > None."""
        if isinstance(key, ConfKey):
            name, reg_default = key.name, key.default
        else:
            name = key
            reg = _REGISTRY.get(key)
            reg_default = reg.default if reg is not None else None
        if name in self:
            return self[name]
        return reg_default if default is _UNSET else default

    def set(self, key: "ConfKey | str", value: Any) -> "TezConfiguration":
        self[key.name if isinstance(key, ConfKey) else key] = value
        return self

    def merged(self, other: Mapping | None) -> "TezConfiguration":
        out = TezConfiguration(self)
        if other:
            out.update(other)
        return out

    def subset(self, prefix: str) -> "TezConfiguration":
        return TezConfiguration(
            {k: v for k, v in self.items() if k.startswith(prefix)})

    @staticmethod
    def registry() -> Iterator[ConfKey]:
        return iter(_REGISTRY.values())


# --------------------------------------------------------------------------
# AM / framework keys (TezConfiguration.java analog)
# --------------------------------------------------------------------------
# registry-compat key superseded by tez.framework.mode  # graftlint: disable=knob-unread
LOCAL_MODE = _key("tez.local.mode", True, Scope.CLIENT,
                  "Run orchestrator in-process (reference: TezConfiguration.TEZ_LOCAL_MODE)")
SESSION_MODE = _key("tez.session.mode", False, Scope.CLIENT,
                    "Keep AM alive across DAGs")
FRAMEWORK_MODE = _key(
    "tez.framework.mode", "local", Scope.CLIENT,
    "'local' = in-process AM; 'remote' = connect to a running AM over "
    "the umbilical wire (client-only key, never shipped into DAG plans)")
AM_ADDRESS = _key(
    "tez.am.address", "", Scope.CLIENT,
    "host:port of the remote AM umbilical endpoint (remote framework "
    "mode; client-only key)")
JOB_TOKEN = _key(
    "tez.job.token", "", Scope.CLIENT,
    "hex-encoded shared job secret authenticating umbilical and shuffle "
    "peers (client-only key, never shipped into DAG plans — see "
    "TezClient._CLIENT_ONLY_KEYS)")
APP_ID = _key(
    "tez.app.id", "", Scope.AM,
    "externally-assigned application id for history/log correlation; "
    "'' = derive one from the submit timestamp")
STAGING_DIR = _key("tez.staging-dir", "/tmp/tez-tpu-staging", Scope.CLIENT)
AM_MAX_APP_ATTEMPTS = _key("tez.am.max.app.attempts", 2, Scope.AM)
TASK_MAX_FAILED_ATTEMPTS = _key("tez.am.task.max.failed.attempts", 4, Scope.VERTEX,
                                "Reference: TezConfiguration.TEZ_AM_TASK_MAX_FAILED_ATTEMPTS")
MAX_ALLOWED_OUTPUT_FAILURES = _key("tez.am.max.allowed.output.failures", 10, Scope.VERTEX)
MAX_ALLOWED_OUTPUT_FAILURES_FRACTION = _key(
    "tez.am.max.allowed.output.failures.fraction", 0.1, Scope.VERTEX)
MAX_ALLOWED_TIME_FOR_READ_ERROR_SEC = _key(
    "tez.am.max.allowed.time-sec.for-read-error", 300, Scope.VERTEX,
    "Output-failure reports persisting past this window fail the source "
    "attempt regardless of counts (consumers stuck too long)")
TASK_RESCHEDULE_HIGHER_PRIORITY = _key(
    "tez.am.task.reschedule.higher.priority", True, Scope.VERTEX,
    "Re-runs after output loss schedule ahead of their vertex's normal "
    "priority (they block live consumers)")
NODE_BLACKLISTING_ENABLED = _key("tez.am.node-blacklisting.enabled", True, Scope.AM)
NODE_BLACKLISTING_FAILURE_THRESHOLD = _key(
    "tez.am.node-blacklisting.ignore-threshold-node-percent", 33, Scope.AM,
    "Blacklists are ignored (nodes FORCED_ACTIVE) above this percent")
NODE_MAX_TASK_FAILURES = _key(
    "tez.am.maxtaskfailures.per.node", 10, Scope.AM,
    "Task-attempt failures on one node before it is blacklisted "
    "(reference: AMNodeImpl)")
AM_CONTAINER_REUSE_ENABLED = _key("tez.am.container.reuse.enabled", True, Scope.AM)
AM_SESSION_MIN_HELD_CONTAINERS = _key("tez.am.session.min.held-containers", 0, Scope.AM)
AM_CONTAINER_IDLE_RELEASE_TIMEOUT_MIN = _key(
    "tez.am.container.idle.release-timeout-min.millis", 5000, Scope.AM)
TASK_HEARTBEAT_TIMEOUT_MS = _key("tez.task.heartbeat.timeout-ms", 300_000, Scope.VERTEX)
# reference-parity key; liveness uses tez.task.heartbeat.timeout-ms  # graftlint: disable=knob-unread
CONTAINER_HEARTBEAT_TIMEOUT_MS = _key("tez.container.heartbeat.timeout-ms", 300_000, Scope.AM)
TASK_PROGRESS_STUCK_INTERVAL_MS = _key("tez.task.progress.stuck.interval-ms", -1, Scope.VERTEX)
SPECULATION_ENABLED = _key("tez.am.speculation.enabled", False, Scope.VERTEX)
SPECULATION_SLOWTASK_THRESHOLD = _key(
    "tez.am.legacy.speculative.slowtask.threshold", 1.0, Scope.VERTEX)
SPECULATION_ESTIMATOR = _key("tez.am.legacy.speculative.estimator.class",
                             "simple_exponential", Scope.VERTEX)
SPECULATION_SMOOTH_LAMBDA_MS = _key(
    "tez.am.legacy.speculative.exponential.smooth.lambda-millis", 30_000,
    Scope.VERTEX,
    "time constant of the exponentially-smoothed progress rate")
SPECULATION_STAGNATED_MS = _key(
    "tez.am.legacy.speculative.exponential.stagnated.millis", 90_000,
    Scope.VERTEX,
    "no progress change for this long marks the attempt stagnated "
    "(estimate becomes infinite)")
SPECULATION_SKIP_INITIALS = _key(
    "tez.am.legacy.speculative.exponential.skip.initials", 8, Scope.VERTEX,
    "progress samples to observe before trusting the smoothed estimate")
SPECULATION_MIN_ALLOWED_TASKS = _key(
    "tez.am.minimum.allowed.speculative.tasks", 10, Scope.VERTEX,
    "floor of the concurrent-speculation cap (reference: "
    "LegacySpeculator.minimumAllowedSpeculativeTasks)")
SPECULATION_PROPORTION_TOTAL = _key(
    "tez.am.proportion.total.tasks.speculatable", 0.01, Scope.VERTEX,
    "cap component: this fraction of ALL tasks may speculate at once")
SPECULATION_PROPORTION_RUNNING = _key(
    "tez.am.proportion.running.tasks.speculatable", 0.1, Scope.VERTEX,
    "cap component: this fraction of RUNNING tasks may speculate at once")
SPECULATION_RETRY_AFTER_NO_SPECULATE_MS = _key(
    "tez.am.soonest.retry.after.no.speculate", 1000, Scope.VERTEX,
    "rescan delay when the last scan launched nothing")
SPECULATION_RETRY_AFTER_SPECULATE_MS = _key(
    "tez.am.soonest.retry.after.speculate", 15_000, Scope.VERTEX,
    "rescan delay after launching a speculation (let it prove itself)")
SPECULATION_SINGLE_TASK_VERTEX_TIMEOUT_MS = _key(
    "tez.am.legacy.speculative.single.task.vertex.timeout", -1, Scope.VERTEX,
    "single-task vertices have no sibling completions to estimate from; "
    "speculate their attempt on this wall-clock timeout instead "
    "(-1 = never, the reference default)")
DAG_RECOVERY_ENABLED = _key("tez.dag.recovery.enabled", True, Scope.AM)
RECOVERY_TRUSTED_STAGING = _key(
    "tez.dag.recovery.trusted-staging", False, Scope.AM,
    "allow pickle-encoded journal payloads during recovery replay (only "
    "safe when the staging dir is writable solely by the framework)")
DAG_RECOVERY_FLUSH_INTERVAL_SECS = _key("tez.dag.recovery.flush.interval.secs", 30, Scope.AM)
AM_EPOCH_FENCING_ENABLED = _key(
    "tez.am.epoch.fencing.enabled", True, Scope.AM,
    "Reject umbilical/commit/shuffle traffic stamped with an older AM "
    "attempt epoch, and stop acting once this AM is itself superseded "
    "(zombie fencing across AM restarts; see docs/recovery.md)")
AM_RECOVERY_QUEUE_REPLAY = _key(
    "tez.am.recovery.queue-replay.enabled", True, Scope.AM,
    "on AM restart, rebuild the admission queue from unresolved "
    "DAG_QUEUED / DAG_REQUEUED_ON_RECOVERY journal records (original "
    "tenant + arrival order preserved; each replay journals a "
    "DAG_REQUEUED_ON_RECOVERY event) — the redeem side of the "
    "lossless-admission contract (docs/recovery.md)")
AM_RECOVERY_REATTACH_RETRIES = _key(
    "tez.am.recovery.reattach.retries", 5, Scope.CLIENT,
    "client re-attach: connection attempts against the captured AM "
    "address before giving up (full-jitter exponential backoff between "
    "tries) — covers the restart window of a crashed AM")
AM_RECOVERY_REATTACH_BACKOFF_MS = _key(
    "tez.am.recovery.reattach.backoff-ms", 200.0, Scope.CLIENT,
    "client re-attach: base of the full-jitter exponential backoff "
    "between connection attempts")
AM_COMMIT_RECOVERY_POLICY = _key(
    "tez.am.commit.recovery.policy", "resume", Scope.AM,
    "What recovery does with a DAG whose commit ledger shows "
    "COMMIT_STARTED without COMMIT_FINISHED/ABORTED: 'resume' re-runs the "
    "idempotent committers and rolls the commit forward; 'fail' keeps the "
    "reference semantics (partial commits fail the DAG)")
AM_HISTORY_LOGGING_ENABLED = _key(
    "tez.am.history.logging.enabled", True, Scope.AM,
    "Master switch for the history logging service (recovery journaling "
    "is unaffected); reference: TEZ_AM_HISTORY_LOGGING_ENABLED")
DAG_HISTORY_LOGGING_ENABLED = _key(
    "tez.dag.history.logging.enabled", True, Scope.DAG,
    "Per-DAG history-logging off switch (set in the DAG conf)")
HISTORY_LOGGING_SERVICE_CLASS = _key(
    "tez.history.logging.service.class",
    "tez_tpu_torch.am.history:InMemoryHistoryLoggingService", Scope.AM)
HISTORY_LOG_DIR = _key("tez.history.logging.log-dir", "", Scope.AM)
AM_NUM_CONTAINERS = _key("tez.am.local.num-containers", 0, Scope.AM,
                         "Local-mode executor slots; 0 = cpu count")
GENERATE_DEBUG_ARTIFACTS = _key("tez.generate.debug.artifacts", False, Scope.DAG)
TEST_FAULT_SPEC = _key(
    "tez.test.fault.spec", "", Scope.DAG,
    "Fault-injection rules armed for this DAG (test/chaos only): "
    "'point:mode[:k=v,..]' rules joined by ';' — modes fail|pfail|delay|"
    "corrupt, params n/p/ms/exc/match.  See tez_tpu.common.faults and "
    "docs/fault_injection.md.  Empty = fault plane disarmed (zero cost)")
TEST_FAULT_SEED = _key(
    "tez.test.fault.seed", 0, Scope.DAG,
    "Seed for the fault plane's deterministic schedule; the same "
    "(spec, seed) pair replays the identical fault storm "
    "(python -m tez_tpu.tools.chaos --seed N prints repro seeds)")
TEST_RAMP_BASE_MS = _key(
    "tez.test.ramp.base-ms", 0.0, Scope.DAG,
    "Base sink latency in ms for the SLO-burn chaos leg's ramp "
    "processor (test/chaos only): each window sleeps base + step x "
    "window_id before committing, so windowed p95 climbs a "
    "deterministic ramp toward the SLO target.  See make "
    "chaos-slo-burn and docs/telemetry.md")
TEST_RAMP_STEP_MS = _key(
    "tez.test.ramp.step-ms", 0.0, Scope.DAG,
    "Per-window latency increment in ms for the SLO-burn chaos leg's "
    "ramp processor (test/chaos only); see tez.test.ramp.base-ms")
DEBUG_LOCKORDER = _key(
    "tez.debug.lockorder", False, Scope.DAG,
    "Arm the runtime lock-order witness for this DAG (test/chaos only): "
    "locks created inside tez_tpu are wrapped to record nested "
    "acquisition edges and flag order inversions, cross-validating the "
    "static graph from tez_tpu.analysis.lockorder (graftlint).  "
    "See docs/static_analysis.md.  Off = zero cost")
TRACE_ENABLED = _key(
    "tez.trace.enabled", False, Scope.DAG,
    "Arm the distributed tracing plane for this DAG: causal spans across "
    "AM submit -> task attempt -> shuffle fetch land in a bounded ring "
    "buffer exportable as Chrome/Perfetto trace_event JSON (GET /trace, "
    "tools/trace_export.py, chaos --trace-out).  Disarmed = single boolean "
    "check per call site, zero allocation (see docs/observability.md)")
TRACE_BUFFER_SPANS = _key(
    "tez.trace.buffer.spans", 32768, Scope.DAG,
    "Ring-buffer capacity of the span plane; oldest spans are evicted "
    "first once full")
OBS_FLIGHT_ENABLED = _key(
    "tez.obs.flight.enabled", False, Scope.DAG,
    "Arm the cross-plane flight recorder for this DAG: a bounded binary "
    "ring journal of span edges, histogram observations, breaker/watchdog "
    "transitions, admission verdicts, store demotions, push admissions and "
    "exchange round plans, snapshottable on demand and auto-dumped on DAG "
    "failure / breaker-open / watchdog fire / admission shed "
    "(tools/doctor.py reads the dumps — see docs/doctor.md).  Disarmed = "
    "single module-flag check per call site, zero allocation")
OBS_FLIGHT_BUFFER_EVENTS = _key(
    "tez.obs.flight.buffer.events", 65536, Scope.DAG,
    "Flight-ring capacity in events (44 bytes each, ~2.8 MiB at the "
    "default); the ring overwrites oldest-first once full")
OBS_FLIGHT_DUMP_DIR = _key(
    "tez.obs.flight.dump.dir", "", Scope.DAG,
    "Directory auto-dump snapshots are written to on DAG failure, "
    "breaker-open, watchdog fire, or admission shed (empty = the "
    "process temp dir)")
OBS_FLIGHT_DUMP_MAX = _key(
    "tez.obs.flight.dump.max", 8, Scope.DAG,
    "Auto-dump budget per arm cycle: at most this many flight snapshots "
    "are written before further triggers are dropped, bounding disk use "
    "under a failure storm")
AM_SLO_SUBMIT_P95_MS = _key(
    "tez.am.slo.submit.p95-ms", 0.0, Scope.AM,
    "Per-tenant SLO target on p95 submit-to-finish DAG latency in ms, "
    "evaluated live from the tenant.<t>.dag.latency histograms; a breach "
    "latches a TENANT_SLO_BREACH history event, bumps slo.breach.* "
    "gauges and surfaces on GET /slo (0 = watchdog off; docs/doctor.md)")
AM_SLO_QUEUE_WAIT_P95_MS = _key(
    "tez.am.slo.queue-wait.p95-ms", 0.0, Scope.AM,
    "Session-wide SLO target on p95 admission queue wait in ms, "
    "evaluated from the am.admit.queue_wait histogram (0 = off)")
AM_SLO_SHED_RATE = _key(
    "tez.am.slo.shed-rate", 0.0, Scope.AM,
    "Per-tenant SLO target on the admission shed fraction "
    "shed/(accepted+shed), e.g. 0.1 breaches past 10% shedding "
    "(0 = off)")
AM_SLO_MIN_COUNT = _key(
    "tez.am.slo.min-count", 3, Scope.AM,
    "Minimum observations (completed DAGs / queue waits / admission "
    "verdicts) before an SLO target is evaluated, so a single outlier "
    "cannot latch a breach")
AM_SLO_WINDOW_P95_MS = _key(
    "tez.am.slo.window.p95-ms", 0.0, Scope.AM,
    "Streaming SLO target on p95 per-window commit latency in ms (cut -> "
    "WINDOW_COMMIT_FINISHED), evaluated live from the stream.window.latency "
    "histogram; a breach latches a TENANT_SLO_BREACH history event under "
    "the stream's tenant and surfaces on GET /slo "
    "(0 = watchdog off; docs/streaming.md)")
METRICS_ENABLED = _key(
    "tez.metrics.enabled", True, Scope.AM,
    "Serve GET /metrics (Prometheus text: counters, latency histograms, "
    "running-task/queued-fetch/epoch gauges) on the AM web UI.  Histogram "
    "recording itself is always on — it is a few bucket increments per "
    "IO-sized operation")
AM_METRICS_SAMPLE_PERIOD_MS = _key(
    "tez.am.metrics.sample-period-ms", 250.0, Scope.AM,
    "Tick period of the live telemetry sampler (am/telemetry.py): every "
    "tick snapshots all histograms, gauges and registered collectors "
    "into the bounded time-series rings that feed GET /metrics.json "
    "windows, burn-rate SLO alerts, GET /doctor/live and graft top.  "
    "The plane is always-on like the flight recorder (one snapshot per "
    "tick off the hot path, inside the 3% armed-overhead budget); "
    "0 disables the sampler thread entirely (docs/telemetry.md)")
AM_METRICS_RING_SAMPLES = _key(
    "tez.am.metrics.ring.samples", 512, Scope.AM,
    "Ring capacity per time series, in samples: ~2 minutes of history at "
    "the default 250 ms period.  The ring evicts oldest-first once full "
    "and counts every eviction (the telemetry accounting surfaced at "
    "GET /metrics.json and flagged by counter_diff on growth)")
AM_METRICS_WINDOW_S = _key(
    "tez.am.metrics.window-s", 10.0, Scope.AM,
    "Default aggregation window for the live surfaces: GET /metrics.json "
    "windowed rate/p50/p95/p99, the continuous doctor's incremental "
    "blame sweep (GET /doctor/live) and graft top all summarize the "
    "last this-many seconds unless the request overrides it")
AM_SLO_BURN_THRESHOLD = _key(
    "tez.am.slo.burn.threshold", 0.85, Scope.AM,
    "Error-budget burn alerting threshold as a fraction of each "
    "tez.am.slo.* target: when a fast-window p95 (or shed rate) crosses "
    "threshold x target the watchdog latches a typed SLO_BURN_ALERT "
    "history event plus a flight MARK — *before* the cumulative "
    "histogram breaches the full target, so a stream trending toward "
    "its SLO pages while there is still budget left.  0 disables burn "
    "evaluation (breach-or-not only, the pre-PR-18 behavior)")
AM_SLO_BURN_FAST_S = _key(
    "tez.am.slo.burn.fast-window-s", 5.0, Scope.AM,
    "Fast burn window in seconds: the trigger window.  A burn alert "
    "latches when this window's p95 crosses threshold x target "
    "(windowed aggregates come from the telemetry sampler's rings, so "
    "the sampler period bounds burn-alert latency)")
AM_SLO_BURN_SLOW_S = _key(
    "tez.am.slo.burn.slow-window-s", 60.0, Scope.AM,
    "Slow burn window in seconds: the clear/hysteresis window.  A "
    "latched burn alert clears only when the slow window's p95 drops "
    "back under threshold x target, so an oscillating stream pages once "
    "per episode instead of once per blip (multi-window burn-rate "
    "evaluation, SRE-workbook style)")
AM_SLO_BURN_MIN_COUNT = _key(
    "tez.am.slo.burn.min-count", 2, Scope.AM,
    "Minimum observations inside the fast window before burn evaluation "
    "runs for a series, so a single slow outlier cannot page")
AM_COMMIT_ALL_OUTPUTS_ON_SUCCESS = _key(
    "tez.am.commit-all-outputs-on-dag-success", True, Scope.DAG,
    "Reference: commit at DAG success vs per-vertex commit (DAGImpl commit modes)")
AM_PREEMPTION_PERCENTAGE = _key("tez.am.preemption.percentage", 10, Scope.AM)
AM_PREEMPTION_HEARTBEATS_BETWEEN = _key(
    "tez.am.preemption.heartbeats-between-preemptions", 3, Scope.AM,
    "Minimum spacing between preemption rounds, in 250 ms AM-heartbeat "
    "periods (reference: TEZ_AM_PREEMPTION_HEARTBEATS_BETWEEN_PREEMPTIONS)")
AM_PREEMPTION_MAX_WAIT_MS = _key(
    "tez.am.preemption.max.wait-time-ms", 60_000, Scope.AM,
    "A top-priority request waiting longer than this forces a preemption "
    "round regardless of pacing")
AM_VERTEX_MAX_TASK_CONCURRENCY = _key(
    "tez.am.vertex.max-task-concurrency", -1, Scope.AM,
    "Cap on simultaneously RUNNING tasks per vertex (-1 = unlimited); "
    "queued work from other vertices fills the skipped slots")
AM_TASK_SCHEDULER_CLASS = _key(
    "tez.am.task.scheduler.class", "local", Scope.AM,
    "'local' (priority heap, unrestricted preemption), 'dag-aware' "
    "(preemption victims restricted to descendants of the waiting "
    "vertices — DagAwareYarnTaskScheduler analog), or module:Class")
AM_CLIENT_HEARTBEAT_TIMEOUT_SECS = _key(
    "tez.am.client.heartbeat.timeout.secs", -1, Scope.AM,
    "Session AM shuts down after this long without any client request "
    "(-1 = never); clients keep sessions alive automatically")
CLIENT_TIMEOUT_MS = _key(
    "tez.client.timeout-ms", 60_000, Scope.CLIENT,
    "Per-RPC socket timeout for remote-AM calls")
SESSION_CLIENT_TIMEOUT_SECS = _key(
    "tez.session.client.timeout.secs", 120, Scope.CLIENT,
    "How long start() retries connecting to a session AM that is still "
    "coming up (reference: TEZ_SESSION_CLIENT_TIMEOUT_SECS)")
CLIENT_ASYNCHRONOUS_STOP = _key(
    "tez.client.asynchronous-stop", True, Scope.CLIENT,
    "Session stop(): fire shutdown_session and return (True, reference "
    "default) vs poll until the AM port closes (False)")
CLIENT_DIAGNOSTICS_WAIT_TIMEOUT_MS = _key(
    "tez.client.diagnostics.wait.timeout-ms", 15_000, Scope.CLIENT,
    "Bound on the synchronous-stop wait for AM exit")
AM_SLEEP_TIME_BEFORE_EXIT_MS = _key(
    "tez.am.sleep.time.before.exit.millis", 0, Scope.AM,
    "Standalone AM lingers this long after session shutdown so clients "
    "can fetch final status (reference: DAGAppMaster exit sleep)")
CLIENT_AM_HEARTBEAT_INTERVAL_SECS = _key(
    "tez.client.am.heartbeat.interval.secs", 5, Scope.CLIENT,
    "Remote-client keepalive ping interval (0 disables); reference: "
    "TezClient.sendAMHeartbeat")
DAG_SCHEDULER_CLASS = _key("tez.am.dag.scheduler.class",
                           "tez_tpu_torch.am.dag_scheduler:DAGSchedulerNaturalOrder", Scope.AM)
THREAD_DUMP_INTERVAL_MS = _key("tez.thread.dump.interval.ms", 0, Scope.VERTEX)
TASK_HBM_BUDGET_BYTES = _key(
    "tez.task.hbm.budget.bytes", 2 << 30, Scope.VERTEX,
    "Per-task HBM budget the MemoryDistributor arbitrates (TPU delta of "
    "the reference's JVM-heap scaling)")
TASK_SCALE_MEMORY_RESERVE_FRACTION = _key(
    "tez.task.scale.memory.reserve-fraction", 0.05, Scope.VERTEX,
    "Budget fraction held back from component grants (reference: "
    "TEZ_TASK_SCALE_MEMORY_RESERVE_FRACTION; smaller here — no JVM "
    "overhead to reserve for)")
TASK_SCALE_MEMORY_RATIOS = _key(
    "tez.task.scale.memory.ratios", "", Scope.VERTEX,
    "'TYPE=WEIGHT,...' oversubscription weights per component type "
    "(reference: WeightedScalingMemoryDistributor ratios); '' = defaults")
TASK_SCALE_MEMORY_ALLOCATOR = _key(
    "tez.task.scale.memory.allocator.class", "weighted", Scope.VERTEX,
    "'weighted' (WeightedScalingMemoryDistributor) or 'uniform' "
    "(ScalingAllocator: every request scales by the same factor)")
TASK_MAX_EVENT_BACKLOG = _key(
    "tez.task.max-event-backlog", 10_000, Scope.VERTEX,
    "Max routed events per heartbeat response; the remainder streams on "
    "later heartbeats (reference: TezTaskAttemptListener maxEventsToGet)")
TASK_AM_HEARTBEAT_INTERVAL_MS = _key(
    "tez.task.am.heartbeat.interval-ms", 50, Scope.VERTEX,
    "TaskReporter heartbeat period (reference: "
    "tez.task.am.heartbeat.interval-ms.max)")
COUNTERS_MAX = _key("tez.counters.max", 1200, Scope.AM,
                    "Counter-per-group cap (Limits.java)")
COUNTERS_MAX_GROUPS = _key("tez.counters.max.groups", 500, Scope.AM,
                           "Counter-group cap (Limits.java)")
COUNTERS_COUNTER_NAME_MAX_LEN = _key(
    "tez.counters.counter-name.max-length", 64, Scope.AM,
    "Counter names truncate to this before lookup (Limits.java)")
COUNTERS_GROUP_NAME_MAX_LEN = _key(
    "tez.counters.group-name.max-length", 256, Scope.AM,
    "Counter-group names truncate to this (Limits.java)")
SHUFFLE_VM_AUTO_PARALLEL = _key(
    "tez.shuffle-vertex-manager.enable.auto-parallel", False, Scope.VERTEX,
    "Let ShuffleVertexManager shrink consumer parallelism from observed "
    "source output size (ShuffleVertexManager.java:78)")
SHUFFLE_VM_MIN_SRC_FRACTION = _key(
    "tez.shuffle-vertex-manager.min-src-fraction", 0.25, Scope.VERTEX,
    "Source-completion fraction at which slow-start begins releasing tasks")
SHUFFLE_VM_MAX_SRC_FRACTION = _key(
    "tez.shuffle-vertex-manager.max-src-fraction", 0.75, Scope.VERTEX,
    "Source-completion fraction at which every consumer task is released")
SHUFFLE_VM_DESIRED_TASK_INPUT_SIZE = _key(
    "tez.shuffle-vertex-manager.desired-task-input-size",
    100 * 1024 * 1024, Scope.VERTEX,
    "Auto-parallelism targets ceil(total/this) consumer tasks")
SHUFFLE_VM_MIN_TASK_PARALLELISM = _key(
    "tez.shuffle-vertex-manager.min-task-parallelism", 1, Scope.VERTEX,
    "Auto-parallelism never shrinks below this")
GROUPING_SPLIT_WAVES = _key(
    "tez.grouping.split-waves", 1.7, Scope.VERTEX,
    "Desired split groups per available slot when vertex parallelism is "
    "unbound (TezSplitGrouper.TEZ_GROUPING_SPLIT_WAVES)")
GROUPING_MIN_SIZE = _key(
    "tez.grouping.min-size", 50 * 1024 * 1024, Scope.VERTEX,
    "Lower bound on average grouped-split size")
GROUPING_MAX_SIZE = _key(
    "tez.grouping.max-size", 1024 * 1024 * 1024, Scope.VERTEX,
    "Upper bound on average grouped-split size")
TASK_JAX_PROFILE_DIR = _key(
    "tez.task.jax-profile.dir", "", Scope.VERTEX,
    "Write a per-task-attempt XLA profiler trace (TensorBoard/Perfetto) "
    "under this dir; '' disables (the TPU-native per-kernel tracing story)")
AM_WEB_ENABLED = _key("tez.am.web.enabled", False, Scope.AM,
                      "Serve the live status endpoint (AMWebController analog)")
AM_WEB_PORT = _key("tez.am.web.port", 0, Scope.AM, "0 = ephemeral")
RUNNER_ENV = _key("tez.am.runner.env", {}, Scope.AM,
                  "Env overrides for runner subprocesses; '' value = unset")
UMBILICAL_BIND_HOST = _key("tez.am.umbilical.bind-host", "127.0.0.1",
                           Scope.AM, "'0.0.0.0' for multi-host deployments")
AM_CONCURRENT_DISPATCHER_SHARDS = _key(
    "tez.am.concurrent.dispatcher.shards", 0, Scope.AM,
    "0 = single dispatcher thread (reference default); N>1 = hash-sharded "
    "concurrent dispatcher for event storms (AsyncDispatcherConcurrent)")
RUNNER_MODE = _key("tez.runner.mode", "threads", Scope.AM,
                   "'threads' (in-process, reference local mode), "
                   "'subprocess' (out-of-process runners over the socket "
                   "umbilical — the TezChild-per-container model), or "
                   "'pods' (external cluster binding: the AM acquires "
                   "runner pods via tez.am.pod-pool.driver.class)")
POD_POOL_DRIVER = _key(
    "tez.am.pod-pool.driver.class", "process", Scope.AM,
    "'process' (process-per-host simulation with the real plugin seam), "
    "'kubernetes' (GKE/k8s pods; needs the kubernetes client), or a "
    "module:Class PodDriver path")
POD_POOL_MAX_PODS = _key("tez.am.pod-pool.max-pods", 0, Scope.AM,
                         "0 = tez.am.local.num-containers")
POD_POOL_ADVERTISE_HOST = _key(
    "tez.am.pod-pool.advertise-host", "127.0.0.1", Scope.AM,
    "AM address handed to launched pods for the umbilical dial-back")
POD_POOL_K8S_NAMESPACE = _key("tez.am.pod-pool.k8s.namespace", "default",
                              Scope.AM)
POD_POOL_K8S_IMAGE = _key("tez.am.pod-pool.k8s.image",
                          "tez-tpu-runner:latest", Scope.AM)
POD_POOL_K8S_POD_TEMPLATE = _key(
    "tez.am.pod-pool.k8s.pod-template", "", Scope.AM,
    "Path to a pod-spec YAML merged under the generated runner pod "
    "(resources, tolerations, TPU node selectors); '' = built-in spec")

# --------------------------------------------------------------------------
# Runtime (per-edge / per-IO) keys (TezRuntimeConfiguration.java analog)
# --------------------------------------------------------------------------
RUNTIME_PREFIX = "tez.runtime."

IO_SORT_MB = _key("tez.runtime.io.sort.mb", 256, Scope.VERTEX,
                  "Device sort span budget (HBM MiB); reference: buffer for PipelinedSorter")
IO_SORT_FACTOR = _key("tez.runtime.io.sort.factor", 64, Scope.VERTEX,
                      "k-way merge width; reference: TezRuntimeConfiguration io.sort.factor")
SORTER_CLASS = _key("tez.runtime.sorter.class", "auto", Scope.VERTEX,
                    "'device' (TPU radix/segmented sort) or 'host' (numpy fallback)")
COMBINER_CLASS = _key("tez.runtime.combiner.class", "", Scope.VERTEX)
SORT_THREADS = _key("tez.runtime.sort.threads", 0, Scope.VERTEX,
                    "Background sortmaster workers (0 = sort spans inline); "
                    "reference: PipelinedSorter sortmaster executor")
PARTITIONER_CLASS = _key("tez.runtime.partitioner.class",
                         "tez_tpu_torch.library.partitioners:HashPartitioner", Scope.VERTEX)
PALLAS_HASH_ENABLED = _key("tez.runtime.tpu.pallas.hash", False, Scope.VERTEX,
                           "Use the Pallas FNV kernel for hash partitioning "
                           "on TPU backends (off until profiled per chip); "
                           "non-TPU backends silently use the XLA path")
PIPELINED_SHUFFLE_ENABLED = _key("tez.runtime.pipelined-shuffle.enabled", False, Scope.VERTEX,
                                 "Emit per-spill DMEs; disables final merge "
                                 "(reference: PipelinedSorter.java:113)")
ENABLE_FINAL_MERGE = _key("tez.runtime.enable.final-merge.in.output", True, Scope.VERTEX)
SHUFFLE_PARALLEL_COPIES = _key("tez.runtime.shuffle.parallel.copies", 8, Scope.VERTEX)
SHUFFLE_BUFFER_FRACTION = _key("tez.runtime.shuffle.fetch.buffer.percent", 0.9, Scope.VERTEX)
SHUFFLE_MEMORY_LIMIT_PERCENT = _key("tez.runtime.shuffle.memory.limit.percent", 0.25, Scope.VERTEX)
SHUFFLE_MERGE_PERCENT = _key("tez.runtime.shuffle.merge.percent", 0.9, Scope.VERTEX)
SHUFFLE_MERGE_BUDGET_MB = _key(
    "tez.runtime.shuffle.merge.budget.mb", 0, Scope.VERTEX,
    "consumer-side fetch/merge memory budget; 0 = use the MemoryDistributor "
    "grant (fetch.buffer.percent x io.sort.mb request)")
# reference-parity key; penalty logic uses the report-window knobs  # graftlint: disable=knob-unread
SHUFFLE_FAILED_CHECK_SINCE_LAST_COMPLETION = _key(
    "tez.runtime.shuffle.failed.check.since-last.completion", True, Scope.VERTEX)
SHUFFLE_FETCH_MAX_TASK_OUTPUT_AT_ONCE = _key(
    "tez.runtime.shuffle.fetch.max.task.output.at.once", 20, Scope.VERTEX)
SHUFFLE_NOTIFY_READERROR = _key("tez.runtime.shuffle.notify.readerror", True, Scope.VERTEX)
SHUFFLE_HOST_PENALTY_BASE_MS = _key(
    "tez.runtime.shuffle.host.penalty.base-ms", 250, Scope.VERTEX,
    "initial penalty-box hold for a failing shuffle host; doubles per "
    "consecutive failure (ShuffleScheduler Penalty/Referee analog)")
SHUFFLE_HOST_PENALTY_CAP_MS = _key(
    "tez.runtime.shuffle.host.penalty.cap-ms", 10_000, Scope.VERTEX)
SHUFFLE_FETCH_ATTEMPTS = _key(
    "tez.runtime.shuffle.fetch.attempts", 4, Scope.VERTEX,
    "connection-level retries per fetch before InputReadErrorEvent")
SHUFFLE_SPECULATIVE_FETCH_WAIT_MS = _key(
    "tez.runtime.shuffle.speculative.fetch.wait-ms", 15_000, Scope.VERTEX,
    "an in-flight fetch older than this gets a duplicate on a fresh "
    "connection; first delivery wins")
SHUFFLE_FETCH_SESSION_TTL_MS = _key(
    "tez.runtime.shuffle.fetch.session.ttl-ms", 30_000, Scope.VERTEX,
    "keep-alive cache for fetch sessions: a healthy per-host connection is "
    "reused across batches and closed after this idle time; open sessions "
    "(cached + in use) never exceed the fetcher pool size; 0 = close after "
    "every batch (the historical behavior)")
SHUFFLE_FETCHER_CLASS = _key(
    "tez.runtime.shuffle.fetcher.class", "", Scope.VERTEX,
    "injectable fetch-session factory (tests: FetcherWithInjectableErrors "
    "analog); empty = TCP keep-alive session")
TPU_MESH_MAX_ROWS_PER_ROUND = _key(
    "tez.runtime.tpu.mesh.max-rows-per-round", 0, Scope.VERTEX,
    "per-edge cap on rows moved per exchange round (skewed partitions run "
    "multi-round above it); 0 = coordinator default "
    "(TEZ_TPU_MESH_MAX_ROWS_PER_ROUND env or 1Mi rows)")
MESH_EXCHANGE_ENGINE = _key(
    "tez.runtime.mesh.exchange.engine", "auto", Scope.VERTEX,
    "ICI collective carrying mesh-exchange edges: 'padded' = fixed "
    "[W, CAP] all_to_all (portable; padding crosses ICI as slack), "
    "'ragged' = ragged_all_to_all (only real rows move; TPU-only, falls "
    "back loudly where the backend lacks the thunk), 'auto' = ragged "
    "when the runtime probe passes, padded otherwise (bit-exact either "
    "way; see docs/exchange.md)")
MESH_EXCHANGE_CODED = _key(
    "tez.runtime.mesh.exchange.coded", "off", Scope.VERTEX,
    "Coded TeraSort-style redundant exchange: 'r2' sends every "
    "partition's rows to its primary device AND one rotation-offset "
    "buddy, and the consumer takes the first complete copy — masks one "
    "slow or faulted chip per exchange at 2x send flops (flops are "
    "cheap, ICI stragglers are not); 'off' = single copy")
MESH_EXCHANGE_SPLIT_AFTER = _key(
    "tez.runtime.mesh.exchange.split.after", 2, Scope.VERTEX,
    "fair-shuffle splitter trigger: after this many CONSECUTIVE "
    "exchanges of a recurring edge with one partition over "
    "max-rows-per-round, hot partitions are re-partitioned across "
    "sub-destinations with a merge-side recombine instead of "
    "re-rounding forever; 0 = never split")
TPU_MESH_MAX_KEY_BYTES = _key(
    "tez.runtime.tpu.mesh.max.key.bytes", 256, Scope.VERTEX,
    "hard cap on key bytes the mesh exchange carries (slot widths "
    "auto-widen to the data below it); bigger records -> host shuffle edge")
TPU_MESH_MAX_VALUE_BYTES = _key(
    "tez.runtime.tpu.mesh.max.value.bytes", 1024, Scope.VERTEX,
    "hard cap on value bytes the mesh exchange carries; bigger records -> "
    "host shuffle edge")
SHUFFLE_SSL_ENABLE = _key(
    "tez.runtime.shuffle.ssl.enable", False, Scope.AM,
    "TLS on every DCN socket (shuffle server/fetcher + AM umbilical); "
    "PEM paths below; in-channel HMAC auth stays on inside the stream "
    "(reference: http/SSLFactory.java + TestSecureShuffle)")
SHUFFLE_SSL_CERT = _key("tez.shuffle.ssl.cert.path", "", Scope.AM,
                        "PEM certificate presented by every endpoint")
SHUFFLE_SSL_KEY = _key("tez.shuffle.ssl.key.path", "", Scope.AM,
                       "PEM private key")
SHUFFLE_SSL_CA = _key("tez.shuffle.ssl.ca.path", "", Scope.AM,
                      "CA bundle both sides verify against (mutual TLS)")
TPU_MESH_EXCHANGE_DEADLINE_SECS = _key(
    "tez.runtime.tpu.mesh.exchange.deadline.secs", 0.0, Scope.VERTEX,
    "straggler defense on the mesh gang barrier: consumers waiting longer "
    "than this for the edge's producers fail the edge actionably (naming "
    "the missing producer task indices) instead of stalling forever; "
    "0 = wait indefinitely (AM task-level failure detection still applies)")
TPU_RESIDENT_KEYS = _key(
    "tez.runtime.tpu.resident.keys", True, Scope.VERTEX,
    "keep sorted key lanes in HBM for downstream device merges "
    "(~(key width + 4) B/row pinned per registered output until DAG "
    "deletion; outside the host memory budgets)")
SHUFFLE_CONNECT_TIMEOUT_MS = _key("tez.runtime.shuffle.connect.timeout", 12_000, Scope.VERTEX)
SHUFFLE_READ_TIMEOUT_MS = _key("tez.runtime.shuffle.read.timeout", 30_000, Scope.VERTEX)
COMPRESS = _key("tez.runtime.compress", False, Scope.VERTEX)
COMPRESS_CODEC = _key("tez.runtime.compress.codec", "zlib", Scope.VERTEX)
KEY_CLASS = _key("tez.runtime.key.class", "bytes", Scope.VERTEX)
VALUE_CLASS = _key("tez.runtime.value.class", "bytes", Scope.VERTEX)
KEY_COMPARATOR_CLASS = _key("tez.runtime.key.comparator.class", "", Scope.VERTEX)
UNORDERED_OUTPUT_BUFFER_SIZE_MB = _key(
    "tez.runtime.unordered.output.buffer.size-mb", 100, Scope.VERTEX)
REPORT_PARTITION_STATS = _key("tez.runtime.report.partition.stats", True, Scope.VERTEX,
                              "Ship per-partition output sizes in VertexManagerEvents "
                              "(feeds auto-parallelism)")
KEY_WIDTH_BYTES = _key("tez.runtime.tpu.key.width.bytes", 16, Scope.VERTEX,
                       "Fixed normalized key width for device radix sort (TPU-specific)")
MESH_VALUE_WIDTH_BYTES = _key(
    "tez.runtime.tpu.mesh.value.width.bytes", 16, Scope.VERTEX,
    "Fixed value lane width for mesh-exchange edges (values are packed "
    "into fixed-width device lanes for the SPMD all-to-all)")
# reference-parity key; span sizing uses hbm budget + bucket ladder  # graftlint: disable=knob-unread
DEVICE_BATCH_RECORDS = _key("tez.runtime.tpu.batch.records", 1 << 20, Scope.VERTEX,
                            "Records per device sort batch (static shape bucket)")
DEVICE_SORT_MIN_RECORDS = _key(
    "tez.runtime.tpu.device.sort.min.records", 1 << 16, Scope.VERTEX,
    "Spans smaller than this sort on host even under the device engine "
    "(dispatch + transfer overhead exceeds the sort); 0 = always device")
SORT_ENGINE_MIN_BYTES = _key(
    "tez.runtime.sort.engine.min-bytes", 1 << 20, Scope.VERTEX,
    "auto-engine floor on a span's total SORT-KEY bytes for the device "
    "path: wide-VALUE spans can clear the record-count bar while carrying "
    "few key bytes, where a device dispatch buys almost no device work; "
    "such spans sort on host.  Only applies when tez.runtime.sorter.class "
    "is 'auto' (an explicit 'device' is never rerouted by width); 0 = off")
SORT_PIPELINE_DEPTH = _key(
    "tez.runtime.sort.pipeline.depth", 2, Scope.VERTEX,
    "async device data plane: max spans past the staging gate at once "
    "(encoded/uploaded/dispatched but not read back).  2 = double "
    "buffering — span k+1 stages while span k is in flight and span k-1 "
    "drains.  0 = synchronous spans.  Only takes effect when the engine "
    "resolves to 'device'")
SORT_PIPELINE_COALESCE_RECORDS = _key(
    "tez.runtime.sort.pipeline.coalesce.records", -1, Scope.VERTEX,
    "span-batching budget for the async device plane: adjacent small "
    "spans coalesce into ONE bucketed dispatch while their total records "
    "fit this budget (amortizes per-dispatch overhead).  -1 = auto "
    "(tez.runtime.tpu.device.sort.min.records), 0 = off")
DEVICE_WATCHDOG_DISPATCH_MS = _key(
    "tez.runtime.device.watchdog.dispatch-ms", 60_000, Scope.VERTEX,
    "deadline for one device dispatch attempt in the async data plane; a "
    "dispatch still in flight past this is abandoned by the watchdog "
    "monitor thread and the span re-sorts through the host engine "
    "(bit-exact).  0 = dispatch unwatched")
DEVICE_WATCHDOG_READBACK_MS = _key(
    "tez.runtime.device.watchdog.readback-ms", 60_000, Scope.VERTEX,
    "deadline for one D2H readback attempt in the async data plane; a "
    "hung readback is abandoned and the span fails over to the host "
    "engine instead of wedging flush().  0 = readback unwatched")
DEVICE_BREAKER_FAILURES = _key(
    "tez.runtime.device.breaker.failures", 3, Scope.VERTEX,
    "consecutive device-attempt failures (watchdog fires, device "
    "exceptions) that trip the sticky per-process circuit breaker; while "
    "open, new spans route straight to the host engine without touching "
    "the device")
DEVICE_BREAKER_COOLDOWN_MS = _key(
    "tez.runtime.device.breaker.cooldown-ms", 5_000, Scope.VERTEX,
    "how long an open device breaker waits before letting ONE probe span "
    "try the device again (half-open); the probe's success re-arms the "
    "device engine, its failure re-opens the breaker for another cooldown")
DEVICE_SPLIT_MIN_BYTES = _key(
    "tez.runtime.device.split.min-bytes", 1 << 20, Scope.VERTEX,
    "floor for OOM-adaptive span splitting: a RESOURCE_EXHAUSTED device "
    "attempt retries on-device with the span halved (recursively) while "
    "the half is still above this many key+value bytes; below it the "
    "span goes to the host engine instead")
MERGE_ENGINE = _key(
    "tez.runtime.merge.engine", "", Scope.VERTEX,
    "engine for the reduce-side merge plane (ShuffleMergeManager / "
    "merge_sorted_runs on the consumer): device|host|auto; '' = follow "
    "tez.runtime.sorter.class.  The device engine merges pre-sorted runs "
    "with the O(N) merge-path ladder over HBM-resident key lanes")
MERGE_ENGINE_MIN_RECORDS = _key(
    "tez.runtime.merge.engine.min-records", 0, Scope.VERTEX,
    "merges smaller than this many records run on host even under the "
    "device merge engine (dispatch + transfer overhead exceeds the merge); "
    "0 = follow tez.runtime.tpu.device.sort.min.records")
MERGE_ASYNC_DEPTH = _key(
    "tez.runtime.merge.async.depth", 2, Scope.VERTEX,
    "async reduce-side merge plane: max background merges past the staging "
    "gate at once (device merge in flight + chunked-run disk write "
    "draining).  2 = double buffering — merge k's disk write overlaps "
    "merge k+1's dispatch, both overlap in-flight fetch commits.  "
    "0 = synchronous background merger (the historical behavior)")
HOST_SPILL_DIR = _key("tez.runtime.tpu.host.spill.dir", "", Scope.VERTEX,
                      "Where device buffers spill when HBM budget is exceeded; "
                      "'' = <staging>/spill")
STORE_ENABLED = _key(
    "tez.runtime.store.enabled", False, Scope.AM,
    "route shuffle outputs through the tiered buffer store "
    "(tez_tpu.store): a reference-counted HBM->host->disk object store "
    "with lease pinning, watermark LRU demotion, and epoch-fenced keys.  "
    "Off = the historical bare-registry data plane")
STORE_DEVICE_CAPACITY_MB = _key(
    "tez.runtime.store.device.capacity-mb", 256, Scope.AM,
    "HBM pool budget for store-resident sorted key lanes; crossing the "
    "high watermark demotes LRU unleased entries to the host tier "
    "(drops their device lanes); 0 = no device tier (lanes drop at "
    "publish)")
STORE_HOST_CAPACITY_MB = _key(
    "tez.runtime.store.host.capacity-mb", 1024, Scope.AM,
    "host-RAM pool budget for store-resident runs; crossing the high "
    "watermark demotes LRU unleased entries to the disk tier "
    "(partition-indexed .prun files)")
STORE_DISK_CAPACITY_MB = _key(
    "tez.runtime.store.disk.capacity-mb", 0, Scope.AM,
    "disk pool budget; only sealed cross-DAG lineage entries are ever "
    "evicted from disk (live DAG outputs are never dropped); "
    "0 = unbounded")
STORE_HIGH_WATERMARK = _key(
    "tez.runtime.store.watermark.high", 0.90, Scope.AM,
    "tier occupancy fraction that triggers LRU demotion")
STORE_LOW_WATERMARK = _key(
    "tez.runtime.store.watermark.low", 0.70, Scope.AM,
    "demotion cascade stops once tier occupancy drops below this "
    "fraction")
STORE_DIR = _key(
    "tez.runtime.store.dir", "", Scope.AM,
    "disk-tier directory for demoted runs and sealed lineage segments; "
    "'' = a per-process temp dir removed on reset")
STORE_LINEAGE_REUSE = _key(
    "tez.runtime.store.lineage.reuse", True, Scope.AM,
    "session mode: committed vertex outputs are sealed under "
    "(vertex spec hash, task index, epoch) lineage keys and served as "
    "cache hits to identical recurring DAGs — the producer task "
    "republishes the stored runs instead of recomputing.  Only "
    "meaningful when the store is enabled")
PUSH_ENABLED = _key(
    "tez.runtime.shuffle.push.enabled", False, Scope.VERTEX,
    "push-based pipelined shuffle: producers ship every pipelined spill "
    "eagerly into the reducer-side buffer store mid-map-wave (same-host "
    "publishes are zero-copy; remote spills ride the shuffle server's "
    "push verb), consumers start in ingest mode, and the merge lane "
    "merges pushed arrivals early.  Implies pipelined spill emission.  "
    "The pull path stays registered as the correctness backstop, so a "
    "dead pusher or a rejected push never loses data.  Off = the "
    "historical pull-only shuffle")
PUSH_THREADS = _key(
    "tez.runtime.shuffle.push.threads", 2, Scope.VERTEX,
    "async pusher thread-pool size per producer task")
PUSH_RETRIES = _key(
    "tez.runtime.shuffle.push.retries", 3, Scope.VERTEX,
    "send attempts per pushed spill (full-jitter exponential backoff "
    "between tries, honoring the admission controller's retry-after "
    "hint); exhausting them abandons the push to the pull backstop")
PUSH_INFLIGHT_LIMIT_MB = _key(
    "tez.runtime.shuffle.push.inflight-limit-mb", 64, Scope.VERTEX,
    "per-destination cap on queued + in-flight pushed bytes; a producer "
    "spilling faster than its reducers admit blocks at submit (map-side "
    "backpressure) instead of ballooning the push queue")
PUSH_SOURCE_QUOTA_MB = _key(
    "tez.runtime.shuffle.push.source-quota-mb", 256, Scope.VERTEX,
    "admission controller: max pushed bytes one source attempt may hold "
    "resident in this host's store; beyond it pushes are rejected with "
    "RETRY-AFTER (the source's spills stay pull-served) so a single "
    "hot mapper cannot crowd out the wave")
PUSH_ADMIT_WATERMARK = _key(
    "tez.runtime.shuffle.push.admit-watermark", 0.85, Scope.VERTEX,
    "admission controller: reject pushes once the store's host tier "
    "would exceed this occupancy fraction — deliberately below the "
    "store's own high watermark so eager pushes never trigger the "
    "demotion cascade that pull-registered data would ride")
PUSH_RETRY_AFTER_MS = _key(
    "tez.runtime.shuffle.push.retry-after-ms", 50.0, Scope.VERTEX,
    "retry-after hint attached to admission rejections; the pusher "
    "sleeps at least this long (plus jittered backoff) before retrying")
PUSH_START_FRACTION = _key(
    "tez.runtime.shuffle.push.start-fraction", 0.05, Scope.VERTEX,
    "map-wave/merge-wave co-scheduling: with push enabled, consumer "
    "tasks of scatter-gather edges are ALL released once this fraction "
    "of source tasks has finished (ingest mode) instead of riding the "
    "slow-start [min, max] ramp — reducers sit ingesting pushed spills "
    "while the map wave is still running")
PUSH_EAGER_MERGE_THRESHOLD = _key(
    "tez.runtime.shuffle.push.eager-merge-threshold", 0.5, Scope.VERTEX,
    "with push enabled, the consumer's background merger starts a "
    "mem->disk merge once committed memory crosses this fraction of the "
    "merge budget (instead of only at tez.runtime.shuffle.merge.percent) "
    "so merge work overlaps the map wave; 0 disables early merging")
PUSH_REPLICAS = _key(
    "tez.runtime.shuffle.push.replicas", 1, Scope.VERTEX,
    "copies of each pushed spill landed in the store: 1 = primary only "
    "(historical behavior); 2 = every push also lands on the coded-buddy "
    "replica key, and a consumer whose primary store entry is lost fails "
    "over to the buddy instead of re-running the producer (Coded "
    "TeraSort-style recovery-without-recomputation; the "
    "store.replica.{bytes,failover} counters account for it — "
    "docs/recovery.md, docs/push_shuffle.md)")
DAG_TENANT = _key(
    "tez.dag.tenant", "", Scope.DAG,
    "tenant id stamped onto the DAG plan at submit (and onto every "
    "TaskSpec of the DAG): the unit of admission caps, fair-share "
    "weighting, store byte quotas, and result-cache governance in the "
    "multi-tenant session AM (docs/multitenancy.md); '' = the anonymous "
    "default tenant")
AM_SESSION_MAX_CONCURRENT_DAGS = _key(
    "tez.am.session.max-concurrent-dags", 1, Scope.AM,
    "resident session AM: how many DAGs may run concurrently; submits "
    "beyond it enter the bounded FIFO admission queue.  1 = the "
    "historical one-DAG-at-a-time session (but queued, not rejected)")
AM_SESSION_QUEUE_SIZE = _key(
    "tez.am.session.queue-size", 8, Scope.AM,
    "bounded FIFO admission queue behind the concurrency cap; a submit "
    "arriving with the queue full is shed with a typed RETRY-AFTER "
    "verdict instead of waiting unboundedly")
AM_SESSION_TENANT_MAX_INFLIGHT = _key(
    "tez.am.session.tenant.max-inflight", 0, Scope.AM,
    "per-tenant cap on running + queued DAGs; a tenant at its cap has "
    "further submits shed with RETRY-AFTER so one tenant cannot occupy "
    "the whole queue.  0 = unlimited")
AM_SESSION_SHED_RETRY_AFTER_MS = _key(
    "tez.am.session.shed.retry-after-ms", 500.0, Scope.AM,
    "retry-after hint attached to admission shed verdicts; clients "
    "sleep at least this long (plus full-jitter backoff) before "
    "resubmitting (TezClient.submit_dag_with_retry)")
AM_SESSION_ADMIT_STORE_WATERMARK = _key(
    "tez.am.session.admit.store-watermark", 0.95, Scope.AM,
    "admission pressure gate: with the buffer store enabled, a submit "
    "finding the host tier beyond this occupancy fraction first asks "
    "the store to relieve pressure (relieve_host_pressure) and is shed "
    "if occupancy stays above the gate — the control-plane analog of "
    "the push-shuffle admit watermark")
AM_SESSION_TENANT_WEIGHTS = _key(
    "tez.am.session.tenant.weights", "", Scope.AM,
    "weighted fair-share across tenants as 'tenantA=3,tenantB=1'; the "
    "task scheduler's deficit round-robin grants slots (and thereby the "
    "async device lanes the tasks drive) proportionally to weight.  "
    "Unlisted tenants weigh 1; '' = all tenants equal")
AM_SESSION_FAIR_SHARE = _key(
    "tez.am.session.fair-share", True, Scope.AM,
    "deficit round-robin tenant fair-share at the task-scheduler "
    "allocation point; off = pure priority-heap order across all "
    "tenants (the historical single-tenant behavior)")
STORE_TENANT_DEVICE_QUOTA_MB = _key(
    "tez.runtime.store.quota.device-mb", 0, Scope.AM,
    "per-tenant cap on device(HBM)-tier resident store bytes; a publish "
    "that would cross it lands on the host tier instead (lanes drop), "
    "so one tenant cannot monopolize HBM.  0 = unlimited")
STORE_TENANT_HOST_QUOTA_MB = _key(
    "tez.runtime.store.quota.host-mb", 0, Scope.AM,
    "per-tenant cap on host-tier resident store bytes; a publish over "
    "quota is refused (StoreQuotaExceeded) and the producer falls back "
    "to its own spill files — isolation, not correctness.  "
    "0 = unlimited")
STORE_TENANT_DISK_QUOTA_MB = _key(
    "tez.runtime.store.quota.disk-mb", 0, Scope.AM,
    "per-tenant cap on disk-tier resident store bytes (demoted runs + "
    "sealed lineage); crossing it evicts that tenant's stalest sealed "
    "lineage entries first.  0 = unlimited")
STORE_RESULT_CACHE_TTL_SECS = _key(
    "tez.runtime.store.quota.result-cache.ttl-secs", 0.0, Scope.AM,
    "governed result cache: sealed lineage entries older than this are "
    "expired (not served, and reaped by the next quota sweep) so "
    "recurring tenants re-derive stale results.  0 = no expiry")
STORE_RESULT_CACHE_MB = _key(
    "tez.runtime.store.quota.result-cache-mb", 0, Scope.AM,
    "per-tenant byte cap on sealed result-cache (lineage) entries; "
    "sealing beyond it evicts that tenant's least-recently-hit sealed "
    "entries.  0 = unlimited")
STORE_RESULT_CACHE_ADMIT = _key(
    "tez.runtime.store.quota.result-cache.admit", "always", Scope.AM,
    "result-cache admission policy at seal time: 'always' seals every "
    "committed lineage-tagged output, 'second-use' seals only lineage "
    "keys already observed once this session (scan-resistant), 'never' "
    "disables sealing (lineage reuse off for quota purposes)")
STREAM_ID = _key(
    "tez.runtime.stream.id", "", Scope.DAG,
    "streaming mode: stream identity stamped onto every per-window DAG "
    "plan (and every TaskSpec) by the window driver; the key of the "
    "(attempt_epoch, window_id) fence registry and the marker recovery "
    "uses to hand window DAGs back to the driver instead of resubmitting "
    "them.  '' = batch DAG (docs/streaming.md)")
STREAM_WINDOW_ID = _key(
    "tez.runtime.stream.window-id", 0, Scope.DAG,
    "streaming mode: the numbered window a per-window DAG computes, "
    "stamped by the window driver; rides every TaskSpec/heartbeat/"
    "shuffle-register/push/store-publish as the second fence coordinate. "
    "0 = batch (never fenced; pre-streaming semantics)")
STREAM_WINDOW_COUNT = _key(
    "tez.runtime.stream.window.count", 100, Scope.AM,
    "count-based window cut: the source seals the open window after this "
    "many ingested records (punctuation, if configured, can cut earlier)")
STREAM_WINDOW_PUNCTUATION = _key(
    "tez.runtime.stream.window.punctuation", "", Scope.AM,
    "punctuation-based window cut: ingesting a record whose key equals "
    "this token seals the open window (the punctuation record itself is "
    "not part of any window).  '' = count-based cuts only")
STREAM_MAX_LAG = _key(
    "tez.runtime.stream.max-lag", 4, Scope.AM,
    "backpressure bound on windows cut but not yet committed: ingest() "
    "blocks (source pacing) once the lag reaches this many windows, "
    "journaling one typed WINDOW_LAGGING event per lag episode and "
    "observing stream.window.lag — bounded lag, never OOM or silent "
    "drop (docs/streaming.md)")
STREAM_INGEST_POLL_MS = _key(
    "tez.runtime.stream.ingest.poll-ms", 10.0, Scope.AM,
    "poll interval of a backpressured ingest() while it waits for the "
    "window lag to drop back under tez.runtime.stream.max-lag")
STREAM_WINDOW_TIMEOUT_SECS = _key(
    "tez.runtime.stream.window.timeout-secs", 120.0, Scope.AM,
    "per-window DAG completion deadline; a window that neither succeeds "
    "nor fails inside it aborts the window (WINDOW_COMMIT_ABORTED) and "
    "fails the stream rather than stalling ingest forever")
STREAM_INPUT = _key(
    "tez.runtime.stream.input", "", Scope.DAG,
    "spool file of the sealed window a per-window DAG reads (CRC-framed "
    "record journal under <staging>/stream/<stream>/); stamped by the "
    "window driver, read by StreamWindowSourceProcessor")
STREAM_OUTPUT_DIR = _key(
    "tez.runtime.stream.output-dir", "", Scope.DAG,
    "directory per-window results land in: the sink writes "
    ".w<N>.<part>.tmp files and the driver's exactly-once committer "
    "renames them to w<N>.part<i> between WINDOW_COMMIT_STARTED and "
    "WINDOW_COMMIT_FINISHED ledger records")

# -- relational query layer (tez_tpu/query, docs/query.md) ------------------

QUERY_BROADCAST_MAX_MB = _key(
    "tez.query.broadcast.max-mb", 32.0, Scope.DAG,
    "planner join-strategy threshold: when the estimated (or, on a "
    "replanned run, observed) build-side size fits under this many MB "
    "the join lowers to a broadcast hash join (one-to-all "
    "UnorderedKVEdge); otherwise to a repartition sort-merge join "
    "(two scatter-gather ordered edges)")
QUERY_JOIN_STRATEGY = _key(
    "tez.query.join.strategy", "auto", Scope.DAG,
    "force the join lowering: 'auto' = pick by stats vs "
    "tez.query.broadcast.max-mb, 'broadcast' / 'repartition' = always "
    "that physical strategy (test/bench override; also what a "
    "PlanFeedback replan pins per node)")
QUERY_REDUCERS = _key(
    "tez.query.reducers", 2, Scope.DAG,
    "downstream parallelism of every query exchange (repartition "
    "join, aggregate, window); a skew replan may raise it per node up "
    "to tez.query.replan.max-reducers")
QUERY_SCAN_SPLITS = _key(
    "tez.query.scan.splits", 2, Scope.DAG,
    "desired text splits (and so task parallelism) of each scan stage")
QUERY_STATS_DIR = _key(
    "tez.query.stats.dir", "", Scope.DAG,
    "side-channel directory where query processors drop per-task "
    "qstats JSON (records/bytes emitted per exchange partition); the "
    "QuerySession aggregates them into the per-node partition-size "
    "histograms PlanFeedback replans from.  '' = stats collection off")
QUERY_OPERATOR_TAG = _key(
    "tez.query.operator", "", Scope.VERTEX,
    "planner-set vertex tag naming the logical plan operator this "
    "vertex executes (e.g. 'hash_join(o_custkey)@a1b2c3d4e5f6'); rides "
    "vertex conf so history events, flight dumps, and the lineage "
    "fingerprint all attribute back to the operator")
QUERY_REPLAN_ENABLED = _key(
    "tez.query.replan.enabled", True, Scope.CLIENT,
    "adaptive re-optimization: after each query run the session feeds "
    "the doctor's per-plane blame and the observed qstats histograms "
    "into PlanFeedback; the next run of the same logical node may flip "
    "join strategy or raise reducer parallelism, journaling one typed "
    "QUERY_REPLANNED summary event per decision")
QUERY_REPLAN_SKEW_FACTOR = _key(
    "tez.query.replan.skew-factor", 4.0, Scope.CLIENT,
    "replan trigger: an exchange whose largest observed partition "
    "exceeds this multiple of the mean size of the other partitions is "
    "skewed — the next plan doubles that node's reducer count (up to "
    "tez.query.replan.max-reducers)")
QUERY_REPLAN_MAX_REDUCERS = _key(
    "tez.query.replan.max-reducers", 8, Scope.CLIENT,
    "ceiling a skew replan may raise a query exchange's parallelism to")


def runtime_conf_subset(conf: Mapping) -> "TezConfiguration":
    """Filter the runtime keys into an edge payload (reference: edge config
    builders serialize only TezRuntimeConfiguration keys into UserPayload)."""
    return TezConfiguration(conf).subset(RUNTIME_PREFIX)
