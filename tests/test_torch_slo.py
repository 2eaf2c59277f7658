"""Port parity of the SLO watchdog and the metric exposition
(obs/slo.py, obs/exposition.py, common/metrics.py render_prometheus and
histograms_from_counters) against tez_tpu's, on the CPU.

Every case feeds both packages the same observations (made from a seed
with numpy) and compares what comes out: the Prometheus text byte for
byte, the parsed exposition, the JSON rows, the watchdog's latched
breaches and burn alerts and the history events it journals.  Wall-clock
stamps (``since``, ``cleared_at``) and observed latencies of real runs
are the only fields left out.  There is no tolerance.
"""
import importlib
import os

import numpy as np
import pytest

ROOTS = ("tez_tpu_torch", "tez_tpu")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "metrics_exposition.txt")
#: wall-clock fields of the watchdog's records
CLOCK_FIELDS = ("since", "cleared_at")


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def _fresh_registries():
    """Both packages' metrics and time-series registries start empty
    (tests/conftest.py resets only tez_tpu's, and only afterwards)."""
    for root in ROOTS:
        mod(root, "common.metrics").registry().reset()
        mod(root, "obs.timeseries").registry().reset()
        mod(root, "common.epoch").reset()
    yield
    for root in ROOTS:
        mod(root, "common.metrics").registry().reset()
        reg = mod(root, "obs.timeseries").registry()
        reg.reset()
        for name in reg.collectors():
            reg.unregister_collector(name)


def both(fn):
    """fn(root) on each package; asserts the observations equal and
    returns the port's."""
    got = {root: fn(root) for root in ROOTS}
    assert got[ROOTS[0]] == got[ROOTS[1]]
    return got[ROOTS[0]]


def fixture_metrics(root):
    """tests/test_exposition.py's fixture, built from `root`'s classes:
    the stream aggregate, a per-stream series, a per-tenant series, a
    lane gauge, a plain gauge and a plain counter group."""
    Histogram = mod(root, "common.metrics").Histogram
    agg = Histogram("stream.window.latency")
    for v in (100.0, 300.0):
        agg.observe(v)
    s1 = Histogram("stream.s1.window.latency")
    s1.observe(100.0)
    ten = Histogram("tenant.acme.dag.latency")
    ten.observe(5000.0)
    hists = {h.name: h for h in (agg, s1, ten)}
    gauges = {"slo.burn.active": 1.0,
              "mesh.lane.0.occupancy": 0.5,
              "tenant.acme.store.bytes": 4096.0}
    counters = {"TaskCounter": {"SPILLED_RECORDS": 3, "INPUT_RECORDS": 12},
                "LatencyHistogram.x": {"COUNT": 9}}
    return hists, gauges, counters


def seeded_metrics(root, seed=5):
    """Seeded observations over every label family, a name that needs
    escaping and a name that needs sanitizing."""
    Histogram = mod(root, "common.metrics").Histogram
    rng = np.random.default_rng(seed)
    names = ("stream.window.latency", "stream.clicks.window.latency",
             "stream.views.window.latency", "tenant.a.dag.latency",
             'tenant.we"ird\\ten\nant.dag.latency', "am.admit.queue_wait",
             "9lives.x-y")
    hists = {}
    for name in names:
        h = Histogram(name)
        for ms in rng.exponential(80.0, int(rng.integers(1, 40))):
            h.observe(float(ms))
        hists[name] = h
    gauges = {f"mesh.lane.{i}.occupancy": float(rng.integers(0, 9)) / 8
              for i in range(3)}
    gauges.update({"stream.clicks.cut": 4.0, "slo.breach.total": 2.0,
                   "tenant.a.store.bytes": 1.5e6})
    counters = {"TaskCounter": {"SPILLED_RECORDS": 7, "OUTPUT_BYTES": 1 << 40},
                'Group "q"': {"na\\me": 3},
                "LatencyHistogram.shuffle.fetch.rtt": {"COUNT": 2}}
    return hists, gauges, counters


# -- common/metrics.py: render_prometheus, histograms_from_counters --------

@pytest.mark.parametrize("make", [fixture_metrics, seeded_metrics])
def test_render_prometheus_matches_tez_tpu(make):
    """Byte-equal text.  render_prometheus does not escape a series name
    in its HELP line (tez_tpu/common/metrics.py:291), so the seeded
    tenant name with a newline breaks the strict parser, the same way on
    both packages (ROADMAP Queue 3)."""
    def render(root):
        hists, gauges, counters = make(root)
        text = mod(root, "common.metrics").render_prometheus(
            hists, gauges, counters)
        try:
            parsed = mod(root, "obs.exposition").parse_exposition(text)
        except ValueError as e:
            parsed = str(e)
        return text, parsed
    text, parsed = both(render)
    assert "tez_latency_stream_window_latency_ms_count" in text
    if make is fixture_metrics:
        assert "tez_latency_stream_window_latency_ms" in parsed
    else:
        assert parsed.startswith("line ")


def test_histograms_from_counters_match_tez_tpu():
    def decode(root):
        metrics = mod(root, "common.metrics")
        counters = mod(root, "common.counters").TezCounters()
        rng = np.random.default_rng(11)
        for name in ("shuffle.fetch.rtt", "spill.write", "device.sort"):
            for ms in rng.lognormal(2.0, 2.0, 50):
                metrics.observe(name, float(ms), counters=counters)
        metrics.observe("overflow", 1e9, counters=counters)
        out = metrics.histograms_from_counters(counters.to_dict())
        empty = metrics.max_bound_from_buckets([0] * metrics.NUM_BUCKETS)
        return out, empty
    out, empty = both(decode)
    assert out["overflow"]["max_ms"] == float("inf") and empty == 0.0


# -- obs/exposition.py --------------------------------------------------------

SPLITS = ("stream.window.latency", "stream.s1.window.latency",
          "tenant.acme.dag.latency", "mesh.lane.3.occupancy",
          "am.admit.queue_wait", "stream.x", "tenant.t", "mesh.lane.1")


@pytest.mark.parametrize("name", SPLITS)
def test_split_labels_match_tez_tpu(name):
    both(lambda root: mod(root, "obs.exposition").split_labels(name))


FILTERS = ({}, {"tenant": "acme"}, {"stream": "s1"}, {"tenant": "a"},
           {"stream": "clicks"}, {"tenant": "nobody", "stream": "s1"})


@pytest.mark.parametrize("make", [fixture_metrics, seeded_metrics])
@pytest.mark.parametrize("filt", FILTERS,
                         ids=lambda f: ",".join(f"{k}={v}" for k, v in
                                                f.items()) or "all")
def test_render_text_matches_tez_tpu(make, filt):
    def render(root):
        hists, gauges, counters = make(root)
        ex = mod(root, "obs.exposition")
        text = ex.render_text(hists, gauges, counters, **filt)
        return text, ex.parse_exposition(text)
    text, _ = both(render)
    if make is fixture_metrics and not filt:
        with open(GOLDEN, encoding="utf-8") as fh:
            assert text == fh.read()


@pytest.mark.parametrize("filt", FILTERS[:3],
                         ids=("all", "tenant", "stream"))
def test_render_json_matches_tez_tpu(filt):
    def render(root):
        hists, gauges, _ = seeded_metrics(root)
        windows = {"stream.clicks.window.latency": {"count": 3, "p95": 64.0},
                   "mesh.lane.1.occupancy": {"last": 0.25}}
        acct = {"series": 9, "evicted": 1, "scrape_errors": 0}
        return mod(root, "obs.exposition").render_json(
            hists, gauges, windows=windows, accounting=acct, window_s=10.0,
            **filt)
    both(render)


BAD_EXPOSITIONS = {
    "untyped": "tez_mystery 1\n",
    "non_cumulative": ("# TYPE tez_latency_x_ms histogram\n"
                       'tez_latency_x_ms_bucket{le="1"} 5\n'
                       'tez_latency_x_ms_bucket{le="2"} 3\n'
                       'tez_latency_x_ms_bucket{le="+Inf"} 5\n'
                       "tez_latency_x_ms_sum 9\n"
                       "tez_latency_x_ms_count 5\n"),
    "count_mismatch": ("# TYPE tez_latency_x_ms histogram\n"
                       'tez_latency_x_ms_bucket{le="+Inf"} 5\n'
                       "tez_latency_x_ms_sum 9\n"
                       "tez_latency_x_ms_count 4\n"),
    "no_inf": ("# TYPE tez_latency_x_ms histogram\n"
               'tez_latency_x_ms_bucket{le="1"} 5\n'
               "tez_latency_x_ms_sum 9\n"
               "tez_latency_x_ms_count 5\n"),
    "duplicate_type": "# TYPE a gauge\n# TYPE a gauge\n",
    "unquoted_label": "# TYPE a gauge\na{k=v} 1\n",
    "bad_value": "# TYPE a gauge\na one\n",
}


@pytest.mark.parametrize("case", sorted(BAD_EXPOSITIONS))
def test_parser_rejections_match_tez_tpu(case):
    def reject(root):
        with pytest.raises(ValueError) as err:
            mod(root, "obs.exposition").parse_exposition(
                BAD_EXPOSITIONS[case])
        return str(err.value)
    both(reject)


# -- obs/slo.py ----------------------------------------------------------------

def strip(obj):
    """Drop the watchdog's wall-clock stamps from its records."""
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k not in CLOCK_FIELDS}
    if isinstance(obj, list):
        return [strip(v) for v in obj]
    return obj


SLO_CONF = {"tez.am.slo.submit.p95-ms": 100.0,
            "tez.am.slo.queue-wait.p95-ms": 20.0,
            "tez.am.slo.shed-rate": 0.25,
            "tez.am.slo.window.p95-ms": 50.0,
            "tez.am.slo.min-count": 2,
            "tez.am.slo.burn.threshold": 0.5,
            "tez.am.slo.burn.fast-window-s": 2.0,
            "tez.am.slo.burn.slow-window-s": 6.0,
            "tez.am.slo.burn.min-count": 2}

#: (tick, series, scale of the tick's exponential latencies): each series
#: ramps up over its target, then settles well under it
SLO_RAMP = {"tenant.a.dag.latency": (40, 400, 400, 30, 10, 5, 5, 5),
            "tenant.b.dag.latency": (10, 10, 10, 10, 10, 10, 10, 10),
            "am.admit.queue_wait": (1, 2, 60, 60, 2, 1, 1, 1),
            "stream.window.latency": (10, 30, 90, 90, 5, 5, 5, 5),
            "stream.clicks.window.latency": (10, 90, 90, 10, 5, 5, 5, 5),
            "stream.views.window.latency": (5, 5, 5, 5, 5, 5, 5, 5)}
SLO_SHEDS = ({"a": {"accepted": 4, "shed": 0}, "b": {"accepted": 2,
                                                     "shed": 0}},
             {"a": {"accepted": 4, "shed": 3}, "b": {"accepted": 2,
                                                     "shed": 1}})


def slo_scenario(root):
    """Eight ticks of seeded observations: after each, one breach sweep
    (the admission controller's tick) and one burn sweep at the tick's
    instant (the telemetry sampler's)."""
    metrics = mod(root, "common.metrics")
    reg = mod(root, "obs.timeseries").registry()
    events = []
    wd = mod(root, "obs.slo").SloWatchdog(
        mod(root, "common.config").TezConfiguration(SLO_CONF),
        journal=events.append)
    rng = np.random.default_rng(21)
    sweeps = []
    for tick in range(8):
        for name, scales in SLO_RAMP.items():
            for ms in rng.exponential(scales[tick], 6):
                metrics.observe(name, float(ms))
        now_ns = (tick + 1) * 1_000_000_000
        reg.sample(now_ns=now_ns)
        stats = SLO_SHEDS[tick % 2]
        sweeps.append((strip(wd.evaluate(stats)),
                       strip(wd.evaluate_burn(now_ns))))
    journal = [(e.event_type.name, strip(dict(e.data))) for e in events]
    return sweeps, journal, strip(wd.status())


def test_watchdog_breaches_and_burns_match_tez_tpu():
    sweeps, journal, status = both(slo_scenario)
    kinds = [t for t, _ in journal]
    assert "TENANT_SLO_BREACH" in kinds and "SLO_BURN_ALERT" in kinds
    # latched and edge-triggered: one breach event per (tenant, kind,
    # stream) episode, however many sweeps stay over the target
    opened = [(d["tenant"], d["kind"], d["stream"]) for t, d in journal
              if t == "TENANT_SLO_BREACH"]
    assert status["total_breaches"] == len(opened)
    assert any(e["event"] == "clear" for e in status["log"])
    assert ("*", "window_p95_ms", "clicks") in opened
    assert not any(s == "views" for _, _, s in opened)


def test_watchdog_off_without_targets():
    def off(root):
        C = mod(root, "common.config")
        slo = mod(root, "obs.slo")
        wd = slo.SloWatchdog(C.TezConfiguration({}))
        return (slo.from_conf(C.TezConfiguration({})), wd.enabled(),
                wd.evaluate({"a": {"accepted": 1, "shed": 1}}),
                wd.evaluate_burn(0))
    assert both(off) == (None, False, [], [])


def am_slo_run(root, tmp, extra):
    """A one-vertex DAG on an AM with declared SLO targets; returns the
    watchdog's breach and burn records (kind, tenant, stream, target) and
    the journaled event types."""
    C = mod(root, "common.config")
    kw = {"device": "cpu"} if root == ROOTS[0] else {}
    am = mod(root, "am.app_master").DAGAppMaster(
        "app_1_slo", C.TezConfiguration(dict(
            {"tez.staging-dir": str(tmp), "tez.am.local.num-containers": 2,
             "tez.am.metrics.sample-period-ms": 0}, **extra)), **kw)
    am.start()
    try:
        P = mod(root, "common.payload")
        D = mod(root, "dag.dag")
        v = D.Vertex.create("v", P.ProcessorDescriptor.create(
            f"{root}.library.processors:SleepProcessor",
            payload={"sleep_ms": 30}), 2)
        for i in range(2):
            dag_id = am.submit_dag(D.DAG.create(f"slo{i}").add_vertex(v)
                                   .create_dag_plan())
            assert am.wait_for_dag(dag_id, timeout=60).name == "SUCCEEDED"
            # a sampler tick after each DAG: the window of the second
            # holds the second DAG's latency
            am.telemetry.tick()
        st = am.slo_watchdog.status()
        keep = ("kind", "tenant", "stream", "target")
        return ([{k: b[k] for k in keep} for b in st["active"]],
                [{k: b[k] for k in keep} for b in st["burn"]["active"]],
                [e.event_type.name for e in am.logging_service.events
                 if "SLO" in e.event_type.name])
    finally:
        am.stop()


@pytest.mark.parametrize("extra", [
    {"tez.am.slo.submit.p95-ms": 0.001, "tez.am.slo.min-count": 1},
    {"tez.am.slo.submit.p95-ms": 10_000.0, "tez.am.slo.min-count": 1,
     "tez.am.slo.burn.threshold": 1e-6, "tez.am.slo.burn.min-count": 1,
     "tez.am.slo.burn.fast-window-s": 3600.0}],
    ids=("breach", "burn"))
def test_am_slo_watchdog_matches_tez_tpu(tmp_path, extra):
    def run(root):
        tmp = tmp_path / root
        tmp.mkdir()
        mod(root, "common.metrics").registry().reset()
        return am_slo_run(root, tmp, extra)
    breaches, burns, kinds = both(run)
    if "tez.am.slo.burn.threshold" in extra:
        assert not breaches and burns and kinds == ["SLO_BURN_ALERT"]
    else:
        assert breaches == [{"kind": "submit_p95_ms", "tenant": "default",
                             "stream": "", "target": 0.001}]
        assert kinds == ["TENANT_SLO_BREACH"]
