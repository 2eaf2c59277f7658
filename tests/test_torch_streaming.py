"""Port parity of streaming mode (am/streaming.py, library/streaming.py,
RecoveryParser.stream_records, DAGAppMaster.open_stream and the stream
resume) against tez_tpu's, on the CPU.

Every scenario of tests/test_streaming.py runs on both packages with the
same seeded records, each in a directory of its own, and the two
observations are compared: the committed part files byte for byte, the
window-commit ledger (record type, window id, replayed), the drivers'
final status and the fences' verdicts.  Everything compared is an
integer, a name or bytes: there is no tolerance.  The port's AMs run on
device="cpu"; chip_smoke.py's phase 19 runs the same streams on the card.
"""
import importlib
import os
import time
import types

import numpy as np
import pytest

import chip_smoke

ROOTS = ("tez_tpu_torch", "tez_tpu")
TIMEOUT = 120


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def _fresh_planes():
    """Both packages' process-global planes start and end clean
    (tests/conftest.py resets only tez_tpu's, and only afterwards)."""
    def reset():
        for root in ROOTS:
            mod(root, "common.epoch").reset()
            mod(root, "common.faults").clear_all()
            mod(root, "common.metrics").registry().reset()
            mod(root, "store").reset_store()
    reset()
    yield
    reset()


def both(tmp_path, scenario):
    """scenario(root, tmp) on each package, each in a directory of its
    own; returns the port's observation after asserting tez_tpu's equal."""
    obs = {}
    for root in ROOTS:
        tmp = tmp_path / root
        tmp.mkdir()
        obs[root] = scenario(root, str(tmp))
    assert obs[ROOTS[0]] == obs[ROOTS[1]]
    return obs[ROOTS[0]]


def seeded_records(n, seed=0, keys=5):
    """n records {"k": "key<i>", "v": v}, i drawn Zipf(1.3) over `keys`
    names, v uniform in [1, 100)."""
    rng = np.random.default_rng(seed)
    ids = rng.zipf(1.3, n) % keys
    vals = rng.integers(1, 100, n)
    return [{"k": f"key{i}", "v": int(v)} for i, v in zip(ids, vals)]


def am_for(root, tmp, app, attempt=1, **conf):
    return chip_smoke.stream_am(root, app, os.path.join(tmp, "staging"),
                                "cpu", attempt=attempt, **conf)


def spec(root, tmp, name, **conf):
    return chip_smoke.stream_spec(root, name, os.path.join(tmp, "out"),
                                  **conf)


def parts(tmp, name):
    return chip_smoke.stream_parts(os.path.join(tmp, "out", name))


def journal(tmp, app, attempt=0):
    return chip_smoke.read_journal(os.path.join(tmp, "staging", app),
                                   attempt)


def status_of(final):
    """The driver's final status without what timing decides."""
    return {k: v for k, v in final.items() if k != "lag_episodes"}


# -- the spool codec ---------------------------------------------------------

SPOOL = seeded_records(40, seed=3) + ["EOW", {"k": "ünï", "v": 2},
                                      {"k": "a\nb", "v": 1}, 7, None]


def test_spool_encoding_matches_tez_tpu():
    lines = {root: [mod(root, "am.streaming").encode_spool_record(r)
                    for r in SPOOL] for root in ROOTS}
    assert lines[ROOTS[0]] == lines[ROOTS[1]]
    for root in ROOTS:
        dec = mod(root, "am.streaming").decode_spool_record
        assert [dec(line) for line in lines[ROOTS[0]]] == SPOOL


@pytest.mark.parametrize("damage", ["none", "torn_tail", "mid_file",
                                    "missing"])
def test_read_spool_matches_tez_tpu(tmp_path, damage):
    """A torn final line (a crash mid-append) is dropped; the same damage
    mid-file raises each package's StreamSpoolError with one message."""
    def read(root, tmp):
        s = mod(root, "am.streaming")
        path = os.path.join(tmp, "w000001.spool")
        lines = [s.encode_spool_record(r) for r in SPOOL]
        if damage == "mid_file":
            lines[1] = lines[1][:8] + lines[1][8:].replace("key", "KEY")
        if damage != "missing":
            with open(path, "w") as fh:
                fh.write("\n".join(lines) + "\n")
        if damage == "torn_tail":
            with open(path, "a") as fh:
                fh.write(s.encode_spool_record({"k": "torn"})[:-4])
        try:
            return s.read_spool(path)
        except s.StreamSpoolError as e:
            return str(e)
    got = both(tmp_path, read)
    if damage in ("none", "torn_tail"):
        assert got == SPOOL
    elif damage == "missing":
        assert got == []
    else:
        assert "CRC mismatch" in got


def framed(payload):
    """A spool line whose CRC matches `payload`, whatever it holds."""
    import zlib
    return "%08x %s" % (zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF,
                        payload)


@pytest.mark.parametrize("line", [
    "nonsense", "zzzzzzzz {}", "00000000 {", "", framed("1 2"),
    framed(" 1"), framed("1 "), framed('{"k": '), framed('"abc'),
    framed("[1,]"), framed("nul"), framed('{"v": 1, "k": "x"}'),
    framed(""), framed("  ")])
def test_spool_lines_decode_as_tez_tpu_does(line):
    """CRC-valid payloads with leading or trailing whitespace, extra data
    or broken JSON, and broken framing: the same record or the same
    StreamSpoolError message in both packages."""
    def decode(root):
        s = mod(root, "am.streaming")
        try:
            return ("ok", s.decode_spool_record(line))
        except s.StreamSpoolError as e:
            return ("error", str(e))
    assert decode(ROOTS[0]) == decode(ROOTS[1])


def test_stream_dir_and_spool_names_match_tez_tpu():
    def names(root):
        s = mod(root, "am.streaming")
        return (s.stream_dir("/st", "app_1", "clicks"), s.spool_name(7),
                s.spool_name(123456, sealed=False))
    assert names(ROOTS[0]) == names(ROOTS[1])


# -- the (attempt_epoch, window_id) fence --------------------------------------

def test_window_registry_matches_tez_tpu():
    def ops(root):
        e = mod(root, "common.epoch")
        app = "app_1_stream"
        return [e.is_stale_window(app, "s", 0), e.is_stale_window(app, "", 5),
                e.is_stale_window(app, "s", 3), e.register_window(app, "s", 3),
                e.is_stale_window(app, "s", 2), e.is_stale_window(app, "s", 3),
                e.is_stale_window(app, "s", 4), e.register_window(app, "s", 2),
                e.current_window(app, "s"), e.is_stale_window(app, "o", 1),
                issubclass(e.WindowFencedError, e.EpochFencedError)]
    got = ops(ROOTS[0])
    assert got == ops(ROOTS[1])
    assert got == [False, False, False, 3, True, False, False, 3, 3, False,
                   True]


def test_umbilical_fences_stale_window_matches_tez_tpu(tmp_path):
    """A straggler stamped with a sealed window is told to die at the
    heartbeat and refused the commit, with the ATTEMPT_FENCED record the
    epoch fence leaves; a batch stamp (window 0) passes."""
    def fence(root, tmp):
        app = "app_1_streamhb"
        am = am_for(root, tmp, app)
        try:
            mod(root, "common.epoch").register_window(app, "s", 2)
            ids = mod(root, "common.ids")
            tc = mod(root, "am.task_comm")
            zombie = ids.TaskAttemptId(
                ids.DAGId(app, 1).vertex(0).task(0), 0)
            dead = am.task_comm.heartbeat(tc.HeartbeatRequest(
                attempt_id=zombie, events=[], epoch=1, window_id=1,
                stream="s")).should_die
            commit = am.task_comm.can_commit(zombie, epoch=1, window_id=1,
                                             stream="s")
            fenced = [dict(e.data) for e in am.logging_service.events
                      if e.event_type.name == "ATTEMPT_FENCED"]
            batch = am.task_comm.heartbeat(tc.HeartbeatRequest(
                attempt_id=zombie, events=[], epoch=1)).should_die
            return dead, commit, fenced, batch
        finally:
            am.stop()
    dead, commit, fenced, batch = both(tmp_path, fence)
    assert dead and not commit and not batch
    assert fenced and fenced[0]["reason"] == "stale_window"


SEAMS = ("register", "push_publish", "fetch_partition", "store.publish",
         "store.republish_lineage", "batch")


@pytest.mark.parametrize("seam", SEAMS)
def test_shuffle_and_store_seams_fence_stale_window(seam):
    """Every seam a zombie of window 4 reaches once window 5 is live
    raises WindowFencedError in both packages; window 0 (batch) never
    does."""
    def hit(root):
        app = "app_1_seams"
        mod(root, "common.epoch").register_window(app, "s", 5)
        svc = mod(root, "shuffle.service").ShuffleService()
        store = mod(root, "store.buffer_store").ShuffleBufferStore()
        calls = {
            "register": lambda: svc.register(
                "p", 0, run=None, app_id=app, window_id=4, stream="s"),
            "push_publish": lambda: svc.push_publish(
                "p", 0, run=None, app_id=app, window_id=4, stream="s"),
            "fetch_partition": lambda: svc.fetch_partition(
                "p", 0, 0, app_id=app, window_id=4, stream="s"),
            "store.publish": lambda: store.publish(
                "p", 0, run=None, app_id=app, window_id=4, stream="s"),
            "store.republish_lineage": lambda: store.republish_lineage(
                "lin", "p2", app_id=app, window_id=4, stream="s"),
            "batch": lambda: svc.register(
                "batchp", 0, run=object(), app_id=app, window_id=0,
                stream="s")}
        try:
            calls[seam]()
            return None
        except Exception as e:  # noqa: BLE001 — the verdict is compared
            return type(e).__name__
        finally:
            store.close()
    got = hit(ROOTS[0])
    assert got == hit(ROOTS[1])
    assert got == (None if seam == "batch" else "WindowFencedError")


# -- the driver --------------------------------------------------------------

def run_stream(root, tmp, app, records, name="clicks", drain=True,
               **conf):
    """records through one stream; (committed part files, the window
    ledger, the final status without its timing, the driver)."""
    am = am_for(root, tmp, app)
    try:
        driver = am.open_stream(spec(root, tmp, name, **conf))
        driver.ingest(records)
        final = driver.drain(timeout=TIMEOUT)
        events = list(am.logging_service.events)
    finally:
        am.stop()
    return (parts(tmp, name), chip_smoke.window_ledger(events),
            status_of(final), final["lag_episodes"],
            sum(1 for e in events if e.event_type.name == "WINDOW_LAGGING"))


@pytest.mark.parametrize("n,count", [(7, 3), (64, 16), (50, 50), (1, 4)])
def test_stream_end_to_end_matches_tez_tpu(tmp_path, n, count):
    records = seeded_records(n, seed=n)
    got = both(tmp_path, lambda root, tmp: run_stream(
        root, tmp, "app_1_e2e", records, **{
            "tez.runtime.stream.window.count": count})[:3])
    files, ledger, final = got
    goldens = chip_smoke.window_parts(records, count)
    windows = len(goldens)
    assert files == {f"w{i:06d}.part0": g
                     for i, g in enumerate(goldens, 1)}
    assert ledger == [(t, w, False) for w in range(1, windows + 1)
                      for t in chip_smoke.WINDOW_LEDGER[:2]]
    assert final["committed"] == list(range(1, windows + 1))
    assert final["retired"] and final["lag"] == 0


def test_punctuation_matches_tez_tpu(tmp_path):
    records = [{"k": "a", "v": 1}, {"k": "b", "v": 2}, "EOW",
               {"k": "a", "v": 10}, "EOW"] + seeded_records(9, seed=4)
    files, _ledger, final = both(tmp_path, lambda root, tmp: run_stream(
        root, tmp, "app_1_punc", records, name="punct", **{
            "tez.runtime.stream.window.count": 100,
            "tez.runtime.stream.window.punctuation": "EOW"})[:3])
    assert final["committed"] == [1, 2, 3]
    assert files["w000001.part0"] == b"a 1\nb 2\n"
    assert files["w000002.part0"] == b"a 10\n"


def test_backpressure_matches_tez_tpu(tmp_path):
    """max-lag 1 with 1-record windows: ingest blocks until the previous
    window commits; nothing is dropped, and each package journals one
    WINDOW_LAGGING per lag episode."""
    records = seeded_records(5, seed=9)
    episodes = {}

    def run(root, tmp):
        files, ledger, final, lag, lagging = run_stream(
            root, tmp, "app_1_lag", records, name="paced", **{
                "tez.runtime.stream.window.count": 1,
                "tez.runtime.stream.max-lag": 1})
        episodes[root] = (lag, lagging)
        return files, ledger, final
    files, _ledger, final = both(tmp_path, run)
    assert final["committed"] == [1, 2, 3, 4, 5]
    for lag, lagging in episodes.values():
        assert lag >= 1 and lagging == lag


def test_publish_window_is_idempotent_matches_tez_tpu(tmp_path):
    def publish(root, tmp):
        am = types.SimpleNamespace(
            app_id="app_1_pub", conf=mod(root, "common.config")
            .TezConfiguration({"tez.staging-dir": tmp}))
        driver = mod(root, "am.streaming").StreamDriver(
            am, spec(root, tmp, "pub"))
        out = os.path.join(tmp, "out", "pub")
        with open(os.path.join(out, ".w000001.part0.tmp"), "w") as fh:
            fh.write("a 1\n")
        first = driver._publish_window(1)
        with open(os.path.join(out, ".w000001.part0.tmp"), "w") as fh:
            fh.write("ZOMBIE\n")
        second = driver._publish_window(1)
        return first, second, parts(tmp, "pub"), sorted(os.listdir(out))
    first, second, files, listing = both(tmp_path, publish)
    assert (first, second) == (1, 1)
    assert files == {"w000001.part0": b"a 1\n"}
    assert listing == ["w000001.part0"]


@pytest.mark.parametrize("name", ["", "window", "a.b"])
def test_invalid_stream_names_match_tez_tpu(tmp_path, name):
    def open_bad(root, tmp):
        am = types.SimpleNamespace(
            app_id="app_1_bad", conf=mod(root, "common.config")
            .TezConfiguration({"tez.staging-dir": tmp}))
        s = mod(root, "am.streaming")
        bad = s.StreamSpec(name=name, plan=chip_smoke.stream_plan(root, "t"),
                           output_dir=os.path.join(tmp, "out"))
        with pytest.raises(s.StreamError) as err:
            s.StreamDriver(am, bad)
        return str(err.value)
    both(tmp_path, open_bad)


# -- AM crash and resume ----------------------------------------------------

def exactly_once(tmp, app):
    """Window id -> WINDOW_COMMIT_FINISHED records across every attempt's
    journal."""
    counts = {}
    for ev in journal(tmp, app):
        if ev.event_type.name == "WINDOW_COMMIT_FINISHED":
            w = ev.data["window_id"]
            counts[w] = counts.get(w, 0) + 1
    return counts


def test_am_crash_mid_stream_matches_tez_tpu(tmp_path):
    """tests/test_streaming.py:320 on both packages: a crash with a
    committed window, a sealed uncommitted one and an open spool; the
    successor keeps the committed window sealed, replays the sealed one
    and resumes the open spool with its records: one
    WINDOW_COMMIT_FINISHED per window across both attempts."""
    records = seeded_records(9, seed=13)
    replayed = {}

    def crash(root, tmp):
        app = "app_1_crash"
        am1 = am_for(root, tmp, app)
        am1.open_stream(spec(root, tmp, "surv", **{
            "tez.runtime.stream.window.count": 3}))
        am1.streams["surv"].ingest(records[:7])
        chip_smoke.wait_for(lambda: chip_smoke.finished_windows(am1) >= 1,
                            "window 1's commit", timeout=TIMEOUT)
        am1.crash()
        mod(root, "common.epoch").reset()
        am2 = am_for(root, tmp, app, attempt=2)
        try:
            am2.recover_and_resume()
            resumed = sorted(am2.streams)
            driver = am2.streams["surv"]
            driver.ingest(records[7:])
            final = driver.drain(timeout=TIMEOUT)
        finally:
            am2.stop()
        replayed[root] = final["replayed"]
        return (resumed, final["committed"], parts(tmp, "surv"),
                exactly_once(tmp, app))
    resumed, committed, files, commits = both(tmp_path, crash)
    assert resumed == ["surv"] and committed == [1, 2, 3]
    assert files == {f"w{i:06d}.part0": g for i, g in
                     enumerate(chip_smoke.window_parts(records, 3), 1)}
    assert commits == {1: 1, 2: 1, 3: 1}
    for got in replayed.values():
        assert set(got) <= {1, 2}


def crash_in_bracket(root, tmp, hold_ms=300, after_crash=None):
    """chip_smoke.py phase 19 B at a small size: the AM crashes while
    window 2's commit bracket is open (a stream.window.commit delay rule
    holds it); attempt 2 replays window 2 and rolls it forward."""
    faults = mod(root, "common.faults")
    records = seeded_records(8, seed=17)
    app = "app_1_bracket"
    faults.install("bracket", faults.parse_spec(
        f"stream.window.commit:delay:ms={hold_ms},n=1,match=@w2"))
    try:
        am1 = am_for(root, tmp, app)
        d1 = am1.open_stream(spec(root, tmp, "b", **{
            "tez.runtime.stream.window.count": 3}))
        d1.ingest(records[:7])
        chip_smoke.wait_for(lambda: any(
            e.event_type.name == "WINDOW_COMMIT_STARTED"
            and e.data["window_id"] == 2
            for e in list(am1.logging_service.events)),
            "window 2's commit", timeout=TIMEOUT)
        am1.crash()
        d1._worker.join(timeout=TIMEOUT)
    finally:
        faults.clear("bracket")
    if after_crash is not None:
        after_crash()
    am2 = am_for(root, tmp, app, attempt=2)
    try:
        am2.recover_and_resume()
        d2 = am2.streams["b"]
        d2.ingest(records[7:])
        final = d2.drain(timeout=TIMEOUT)
    finally:
        am2.stop()
    return ([chip_smoke.window_ledger(journal(tmp, app, a))
             for a in (1, 2)], status_of(final), parts(tmp, "b"),
            records)


def test_crash_inside_commit_bracket_rolls_forward_matches_tez_tpu(
        tmp_path):
    (ledger1, ledger2), final, files, records = both(
        tmp_path, crash_in_bracket)
    assert ledger1 == [("WINDOW_COMMIT_STARTED", 1, False),
                       ("WINDOW_COMMIT_FINISHED", 1, False),
                       ("WINDOW_COMMIT_STARTED", 2, False)]
    assert ledger2 == [("WINDOW_COMMIT_STARTED", 2, False),
                       ("WINDOW_COMMIT_FINISHED", 2, True),
                       ("WINDOW_COMMIT_STARTED", 3, False),
                       ("WINDOW_COMMIT_FINISHED", 3, False)]
    assert final["committed"] == [1, 2, 3] and final["replayed"] == [2]
    assert files == {f"w{i:06d}.part0": g for i, g in
                     enumerate(chip_smoke.window_parts(records, 3), 1)}


def test_commit_failure_aborts_the_window_as_tez_tpu_does(tmp_path):
    """A stream.window.commit fail rule on a live AM aborts window 2 in
    both packages (WINDOW_COMMIT_ABORTED, its tmp files dropped, the
    stream failed) rather than leaving its bracket open, and a successor
    skips the aborted window: its records reach no part file (ROADMAP
    Queue 3)."""
    records = seeded_records(9, seed=19)

    def fail(root, tmp):
        faults = mod(root, "common.faults")
        s = mod(root, "am.streaming")
        app = "app_1_abort"
        faults.install("abort", faults.parse_spec(
            "stream.window.commit:fail:n=1,match=@w2"))
        try:
            am1 = am_for(root, tmp, app)
            d1 = am1.open_stream(spec(root, tmp, "f", **{
                "tez.runtime.stream.window.count": 3}))
            d1.ingest(records[:7])
            chip_smoke.wait_for(lambda: d1.status()["error"] is not None,
                                "the stream's failure", timeout=TIMEOUT)
            with pytest.raises(s.StreamFailedError):
                d1.drain(timeout=TIMEOUT)
            first = status_of(d1.status())
            first.pop("error")
            am1.crash()
        finally:
            faults.clear("abort")
        am2 = am_for(root, tmp, app, attempt=2)
        try:
            am2.recover_and_resume()
            d2 = am2.streams["f"]
            d2.ingest(records[7:])
            final = d2.drain(timeout=TIMEOUT)
        finally:
            am2.stop()
        return (first, chip_smoke.window_ledger(journal(tmp, app)),
                status_of(final), parts(tmp, "f"))
    first, ledger, final, files = both(tmp_path, fail)
    assert first["aborted"] == [2] and first["committed"] == [1]
    assert ("WINDOW_COMMIT_ABORTED", 2, False) in ledger
    assert final["committed"] == [1, 3] and final["aborted"] == [2]
    goldens = chip_smoke.window_parts(records, 3)
    assert files == {"w000001.part0": goldens[0],
                     "w000003.part0": goldens[2]}


def test_stream_records_match_tez_tpu(tmp_path):
    """RecoveryParser.stream_records over each package's own journals of
    the in-bracket crash, after attempt 1 and after attempt 2: the same
    ledger state (the spec's plan names each package's classes, so it is
    left out)."""
    def records(root, tmp):
        rec = mod(root, "am.recovery")
        views = []

        def view():
            parser = rec.RecoveryParser(os.path.join(tmp, "staging"),
                                        "app_1_bracket")
            views.append({
                s: {k: sorted(v) if isinstance(v, set) else v
                    for k, v in r.items() if k != "spec"}
                for s, r in parser.stream_records().items()})
        crash_in_bracket(root, tmp, after_crash=view)
        view()
        return views
    crashed, done = both(tmp_path, records)
    assert crashed["b"]["open_started"] == [2]
    assert crashed["b"]["committed"] == [1] and not crashed["b"]["retired"]
    assert done["b"]["committed"] == [1, 2, 3] and done["b"]["retired"]
    assert done["b"]["open_started"] == [] and done["b"]["last_committed"] \
        == 3


# -- the window DAGs on the port's kernels -----------------------------------

def test_window_dags_run_the_kernels_at_the_floor(tmp_path, monkeypatch):
    """With the sorter's device floor at one record (chip_smoke.FLOOR_CONF),
    each window DAG's source spans hash with fnv_hash_lanes and the sink
    merges with merge_path_pair: the kernels' wrappers, on their plain
    versions here."""
    from test_torch_dag import KernelSpy
    spy = KernelSpy(monkeypatch)
    records = seeded_records(600, seed=23, keys=40)
    am = am_for("tez_tpu_torch", str(tmp_path), "app_1_floor",
                **chip_smoke.FLOOR_CONF)
    calls = []
    try:
        driver = am.open_stream(spec("tez_tpu_torch", str(tmp_path), "k", **{
            "tez.runtime.stream.window.count": 200}))
        for w in range(3):
            for k in spy.calls:
                spy.calls[k] = 0
            driver.ingest(records[w * 200:(w + 1) * 200])
            chip_smoke.wait_for(
                lambda: chip_smoke.finished_windows(am) > w,
                f"window {w + 1}", timeout=TIMEOUT)
            calls.append(dict(spy.calls))
        driver.drain(timeout=TIMEOUT)
    finally:
        am.stop()
    for c in calls:
        assert c["fnv_hash_lanes"] > 0 and c["merge_path_pair"] > 0, calls
    assert parts(str(tmp_path), "k") == {
        f"w{i:06d}.part0": g for i, g in
        enumerate(chip_smoke.window_parts(records, 200), 1)}


def test_stream_phase_on_the_host():
    """chip_smoke's phase 19 at TINY_STREAM on the CPU: every check of its
    three legs but the kernel launches (the plain versions launch none)."""
    import tempfile
    args = types.SimpleNamespace(seed=0)
    with tempfile.TemporaryDirectory() as d:
        corpus = chip_smoke.DagCorpus(d, args, corpus_mb=2,
                                      vocab_size=20_000, marks_mb=(2,))
        t0 = time.perf_counter()
        out = chip_smoke.stream_phase(args, corpus, device="cpu",
                                      **chip_smoke.TINY_STREAM)
        # phase 21 D's fsck of the stream's journals, against tez_tpu's
        from test_torch_journal_fsck import fsck_matches_tez_tpu
        fsck_matches_tez_tpu(os.path.join(d, "stream", "staging_a"))
    assert set(out["legs"]) == {"A-B", "A slo", "C"}
    assert time.perf_counter() - t0 < 120
