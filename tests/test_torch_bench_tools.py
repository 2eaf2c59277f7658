"""Port parity of the C++ baseline proxies, the device key encode and the
bench harnesses (native/baseline_proxy.cpp, ops/native.py's proxy
bindings, ops/keycodec.py encode_keys_device, tools/{bench_diff,
profile_kernels,exchange_bench,sort_bench,spill_bench}.py, version.py).

Each case runs the same seeded input through tez_tpu (JAX on the CPU, its
own host library) and the port (device="cpu": the kernels' plain
versions, the port's own host library), and compares without tolerance:
the proxies' outputs byte for byte, the encoded lanes bit for bit, the
harnesses' outputs, signatures, counters and verdicts.  Walls and rates
are not compared.
"""
import collections
import json

import numpy as np
import pytest
import torch

import tez_tpu
import tez_tpu_torch
from tez_tpu.ops import keycodec as jkeycodec
from tez_tpu.ops import native as jnative
from tez_tpu.store import reset_store as jreset_store
from tez_tpu.tools import bench_diff as jbench_diff
from tez_tpu.tools import exchange_bench as jexchange_bench
from tez_tpu.tools import sort_bench as jsort_bench
from tez_tpu.tools import spill_bench as jspill_bench
from tez_tpu_torch.ops import keycodec, native
from tez_tpu_torch.store import reset_store
from tez_tpu_torch.tools import (bench_diff, exchange_bench,
                                 profile_kernels, sort_bench, spill_bench)


@pytest.fixture(scope="module", autouse=True)
def _tez_tpu_library():
    assert jnative.native_available(), "tez_tpu's libtezhost.so must load"


@pytest.fixture()
def clean_stores():
    reset_store()
    jreset_store()
    yield
    reset_store()
    jreset_store()


def test_version_matches_tez_tpu():
    from tez_tpu_torch.version import __version__
    assert tez_tpu_torch.__version__ == __version__ == tez_tpu.__version__


# ---------------------------------------------------------------------------
# the proxies
# ---------------------------------------------------------------------------
OWC_TEXT = b"tick tock tick boom tick tock\n" * 3000 + b"quux tock\n" * 1500


@pytest.mark.parametrize("combine", [True, False])
def test_owc_proxy_matches_tez_tpu(combine):
    """tests/test_ops.py:687's text: the same output bytes, the golden
    counts in non-decreasing count order."""
    secs, out = native.owc_proxy(OWC_TEXT, 4, 4, combine=combine)
    _jsecs, jout = jnative.owc_proxy(OWC_TEXT, 4, 4, combine=combine)
    assert out == jout
    got, prev = {}, -1
    for line in out.decode().splitlines():
        w, c = line.rsplit("\t", 1)
        got[w.encode()] = int(c)
        assert int(c) >= prev
        prev = int(c)
    assert got == dict(collections.Counter(OWC_TEXT.split()))
    assert secs > 0


def test_owc_proxy_grows_its_buffer_for_distinct_words():
    """A corpus of distinct short words outgrows the first output buffer
    (its output is longer than its input): both retry to the same
    bytes."""
    rng = np.random.default_rng(5)
    words = {bytes(rng.integers(97, 123, 3).astype(np.uint8))
             for _ in range(200_000)}
    text = b" ".join(sorted(words)) + b"\n"
    _secs, out = native.owc_proxy(text, 2, 3)
    assert out == jnative.owc_proxy(text, 2, 3)[1]
    assert len(out) > len(text)


@pytest.mark.parametrize("combine", [True, False])
def test_owc_proxy_counts_matches_tez_tpu(tmp_path, combine):
    rng = np.random.default_rng(7)
    vocab = [bytes(rng.integers(97, 123, int(rng.integers(1, 12)))
                   .astype(np.uint8)) for _ in range(3000)]
    ids = rng.zipf(1.3, 60_000) % len(vocab)
    lines = [b" ".join(vocab[i] for i in ids[s:s + 64])
             for s in range(0, len(ids), 64)]
    path = tmp_path / "corpus.txt"
    path.write_bytes(b"\n".join(lines) + b"\n")
    _secs, counts = native.owc_proxy_counts(str(path), 3, 2,
                                            combine=combine)
    _jsecs, jcounts = jnative.owc_proxy_counts(str(path), 3, 2,
                                               combine=combine)
    assert counts == jcounts
    golden = collections.Counter()
    for i, c in collections.Counter(ids.tolist()).items():
        golden[vocab[i].decode()] += c      # short words repeat in vocab
    assert counts == dict(golden)


def test_owc_proxy_counts_raises_on_a_corrupt_output(tmp_path, monkeypatch):
    """A wrong baseline never passes for an absent one."""
    path = tmp_path / "c.txt"
    path.write_bytes(b"a b\n")
    monkeypatch.setattr(native, "owc_proxy",
                        lambda *a, **k: (0.1, b"no-tab-here\n"))
    with pytest.raises(ValueError):
        native.owc_proxy_counts(str(path), 1, 1)


@pytest.mark.parametrize("producers,partitions,n,key_len,val_len", [
    (4, 4, 50_000, 12, 8),     # bench.py's kernel-bench shape, cut
    (3, 7, 9_999, 5, 3),
    (1, 1, 100, 4, 0),
])
def test_pipelined_sorter_proxy_matches_tez_tpu(producers, partitions, n,
                                                key_len, val_len):
    """Keys, values and partition counts equal tez_tpu's proxy and the
    stable (FNV partition, key bytes) order of the records."""
    rng = np.random.default_rng(n)
    # a small alphabet: many equal keys, so the tie-break shows
    keys = rng.integers(97, 100, (n, key_len), dtype=np.uint8)
    vals = rng.integers(0, 256, (n, val_len), dtype=np.uint8)
    secs, out_k, out_v, counts = native.pipelined_sorter_proxy(
        keys, vals, producers, partitions)
    _js, jk, jv, jc = jnative.pipelined_sorter_proxy(
        keys, vals, producers, partitions)
    assert np.array_equal(out_k, jk) and np.array_equal(out_v, jv)
    assert np.array_equal(counts, jc) and secs >= 0
    from tez_tpu_torch.ops.host_sort import fnv_rows_host
    part = fnv_rows_host(keys, np.full(n, key_len, np.int64)) % partitions
    order = np.lexsort([keys[:, j] for j in range(key_len - 1, -1, -1)] +
                       [part])
    assert np.array_equal(out_k, keys[order])
    assert np.array_equal(out_v, vals[order])
    assert np.array_equal(counts, np.bincount(part, minlength=partitions))
    assert native.calls["pipelined_sorter_proxy"] >= 1


def test_pipelined_sorter_proxy_rejects_bad_shapes():
    keys = np.zeros((4, 2), np.uint8)
    with pytest.raises(ValueError):
        native.pipelined_sorter_proxy(keys, np.zeros((3, 1), np.uint8), 1, 1)
    with pytest.raises(ValueError):
        native.pipelined_sorter_proxy(keys, np.zeros((4, 1), np.uint8), 0, 1)


# ---------------------------------------------------------------------------
# the device key encode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("width", [4, 16, 31])
def test_encode_keys_device_matches_tez_tpu(width):
    """tests/test_ops.py:563's keys (lengths up to 40, so every width has
    over-width keys): the port's lanes bit for bit tez_tpu's device and
    host encodes, its lengths theirs."""
    rng = np.random.default_rng(3)
    rows = [rng.integers(97, 123, rng.integers(0, 41), dtype=np.int64)
            .astype(np.uint8) for _ in range(500)]
    kb = np.concatenate([r for r in rows if len(r)])
    ko = np.cumsum([0] + [len(r) for r in rows]).astype(np.int64)
    lanes, lens = keycodec.encode_keys_device(kb, ko, width, device="cpu")
    assert lanes.dtype == torch.int32 and lens.dtype == torch.int32
    assert tuple(lanes.shape) == (500, (width + 3) // 4)
    jlanes, jlens = jkeycodec.encode_keys_device(kb, ko, width)
    got = lanes.numpy().view(np.uint32)
    assert np.array_equal(got, np.asarray(jlanes))
    assert np.array_equal(got, keycodec.encode_keys(kb, ko, width)[0])
    assert np.array_equal(lens.numpy().astype(np.int64),
                          np.asarray(jlens).astype(np.int64))


def test_encode_keys_device_empty_and_no_card():
    lanes, lens = keycodec.encode_keys_device(
        np.zeros(0, np.uint8), np.zeros(4, np.int64), 6, device="cpu")
    assert tuple(lanes.shape) == (3, 2) and not lanes.any()
    assert tuple(lens.shape) == (3,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            keycodec.encode_keys_device(np.ones(4, np.uint8),
                                        np.array([0, 4]), 4)


def test_profile_kernels_on_the_cpu():
    """On the CPU the plain hash and both encodes run, each pair equal
    before it is timed, and the kernel leg is absent (as tez_tpu's
    Pallas leg is off the TPU)."""
    rec = profile_kernels.profile(4096, device="cpu", reps=1)
    assert rec["device"] == "cpu" and rec["rows"] == 4096
    assert "hash_kernel_s" not in rec
    for key in ("hash_plain_s", "encode_host_s", "encode_device_s"):
        assert rec[key] > 0
    # the ratio as tez_tpu rounds it (3 places: a stalled device leg on a
    # loaded host can round it to 0.0)
    assert rec["device_encode_speedup"] == round(
        rec["encode_host_s"] / rec["encode_device_s"], 3)
    # the plain leg's hash is the host partitioner's
    from tez_tpu.ops.host_sort import fnv_rows_host
    from tez_tpu_torch.ops import kernels
    mat, lens = keycodec.pad_to_matrix(*profile_kernels._make_keys(64), 16)
    plain = kernels.fnv_hash_bytes_plain(
        torch.from_numpy(mat), torch.from_numpy(lens), 8).numpy()
    assert np.array_equal(plain, fnv_rows_host(mat, lens) % 8)


# ---------------------------------------------------------------------------
# bench_diff
# ---------------------------------------------------------------------------
def test_bench_diff_matches_tez_tpu(tmp_path, capsys):
    """tests/test_tools.py:287's files: the same verdicts and report."""

    def write(name, values):
        lines = [json.dumps({
            "metric": f"{m} (qualifiers change {name})", "value": v,
            "unit": "MB/s", "vs_baseline": 1.0})
            for m, v in values.items()]
        p = tmp_path / name
        p.write_text(json.dumps({"tail": "\n".join(lines), "rc": 0}))
        return str(p)

    old = write("old.json", {"sort": 100.0, "e2e": 50.0, "stalled": 0.0})
    ok = write("ok.json", {"sort": 85.0, "e2e": 60.0, "stalled": 0.0})
    bad = write("bad.json", {"sort": 70.0, "e2e": 60.0, "stalled": 0.0})
    raw = tmp_path / "raw.txt"
    raw.write_text("noise\n" + json.dumps(
        {"metric": "sort (raw)", "value": 99.0, "unit": "MB/s"}) + "\n")
    floor = write("floor.json", {"sort": 100.0})
    floored = tmp_path / "floored.txt"
    floored.write_text(json.dumps({"metric": "sort (x)", "value": 100.0,
                                   "unit": "MB/s", "vs_baseline": 1.1,
                                   "min_vs_baseline": 1.3}) + "\n")
    for a, b, rc in ((old, ok, 0), (old, bad, 1), (old, str(raw), 0),
                     (floor, str(floored), None)):
        got = bench_diff.diff(a, b)
        out = capsys.readouterr().out
        want = jbench_diff.diff(a, b)
        assert got == want and (rc is None or got == rc)
        assert out == capsys.readouterr().out
    assert bench_diff.main([old, bad]) == jbench_diff.main([old, bad]) == 1
    out = capsys.readouterr().out
    assert "REGRESSION" in out


# ---------------------------------------------------------------------------
# exchange_bench
# ---------------------------------------------------------------------------
def _leg_outputs(mod, coord, spans, tag, **kw):
    return mod._sig(mod._run_leg(coord, spans, f"{tag}/a->b", **kw))


def test_exchange_bench_signatures_match_tez_tpu():
    """The skewed corpus and every leg's consumer outputs: the port's on
    an 8-CPU mesh against tez_tpu's padded baseline on its 8 forced host
    devices (XLA:CPU has no ragged all-to-all)."""
    from tez_tpu.parallel.coordinator import (
        MeshExchangeCoordinator as JCoordinator)
    from tez_tpu_torch.parallel.coordinator import MeshExchangeCoordinator
    spans = exchange_bench._skewed_corpus()
    jspans = jexchange_bench._skewed_corpus()
    for a, b in zip(spans, jspans):
        for field in ("key_bytes", "key_offsets", "val_bytes",
                      "val_offsets"):
            assert np.array_equal(getattr(a, field), getattr(b, field))
    want = _leg_outputs(jexchange_bench, JCoordinator(legacy_sizing=True),
                        jspans, "padded", engine="padded")
    from tez_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(devices=["cpu"] * exchange_bench.CONSUMERS)
    legs = {"padded": (dict(legacy_sizing=True), dict(engine="padded")),
            "skew": ({}, dict(engine="auto")),
            "coded": ({}, dict(engine="auto", coded="r2")),
            "ragged": ({}, dict(engine="ragged"))}
    for tag, (ckw, kw) in legs.items():
        got = _leg_outputs(exchange_bench,
                           MeshExchangeCoordinator(mesh=mesh, **ckw),
                           spans, tag, **kw)
        assert got == want, tag
    # a hot partition of exactly HOT_FRAC of the rows
    from tez_tpu_torch.ops.host_sort import fnv_rows_host
    keys = np.concatenate([s.key_bytes for s in spans]).reshape(
        -1, exchange_bench.KEY_BYTES)
    part = fnv_rows_host(keys, np.full(len(keys), exchange_bench.KEY_BYTES,
                                       np.int64)) % exchange_bench.CONSUMERS
    assert int((part == exchange_bench.HOT_PART).sum()) >= \
        int(exchange_bench.ROWS * exchange_bench.HOT_FRAC)


def test_bench_exchange_records_on_an_eight_cpu_mesh():
    recs = exchange_bench.bench_exchange(device="cpu", mesh=["cpu"] * 8)
    names = [r["metric"].split(" (")[0] for r in recs]
    assert names == ["exchange skewed shuffle padded-maxcap",
                     "exchange skewed shuffle ragged",
                     "exchange skewed shuffle coded-r2",
                     "exchange skewed shuffle skew-aware"]
    assert all(r["value"] > 0 and r["unit"] == "MB/s" for r in recs)
    assert recs[-1]["min_vs_baseline"] == exchange_bench.MIN_VS_BASELINE
    # fewer than 2 workers: tez_tpu's sentinel record
    (sentinel,) = exchange_bench.bench_exchange(device="cpu", mesh=["cpu"])
    assert sentinel == {"metric": "exchange skewed shuffle (needs >= 2 "
                                  "devices)", "value": 0.0, "unit": "MB/s",
                        "vs_baseline": 0.0}
    assert exchange_bench.bench_exchange(device="cpu") == [sentinel]


# ---------------------------------------------------------------------------
# sort_bench and spill_bench
# ---------------------------------------------------------------------------
SORT_PUSH_CONF = {
    "tez.runtime.shuffle.push.enabled": True,
    "tez.runtime.shuffle.push.source-quota-mb": 8,
    "tez.runtime.store.enabled": True,
    "tez.runtime.store.device.capacity-mb": 0,
    "tez.runtime.store.host.capacity-mb": 48,
    "tez.runtime.store.lineage.reuse": False,
    # tez_tpu's pipelined output on its async plane trips tests/conftest.py's
    # lock-order witness (tests/test_torch_push.py)
    "tez.runtime.sort.pipeline.depth": 0,
}


@pytest.mark.parametrize("leg", ["pull", "push"])
def test_run_sort_matches_tez_tpu(tmp_path, clean_stores, leg):
    """One sort DAG of 4 MB a producer at io.sort.mb 1 (every producer
    spills): each reducer's records and key CRC, and the spill and push
    counters, equal across the packages; push pushed."""
    extra = SORT_PUSH_CONF if leg == "push" else None
    args = (4, 2, 2, 1, 16)
    state, res, counters, _wall = sort_bench._run_sort(
        str(tmp_path / "t"), leg, *args, extra_conf=extra, device="cpu")
    jstate, jres, jcounters, _jwall = jsort_bench._run_sort(
        str(tmp_path / "j"), leg, *args, extra_conf=extra)
    assert state == jstate == "SUCCEEDED"
    assert res == jres and len(res.splitlines()) == 2
    assert sum(int(line.split()[0]) for line in res.splitlines()) == \
        2 * (4 << 20) // (sort_bench.REC_KEY_BYTES + sort_bench.REC_VAL_BYTES)
    assert counters["SPILLED_RECORDS"] == jcounters["SPILLED_RECORDS"] > 0
    if leg == "push":
        assert counters.get("SHUFFLE_PUSH_BYTES", 0) > 0
        assert jcounters.get("SHUFFLE_PUSH_BYTES", 0) > 0


def test_bench_sort_on_the_cpu(monkeypatch, clean_stores):
    """The whole harness at 16 MB: both legs spilled, push pushed, the
    outputs bit-identical; the record names the device."""
    for k, v in {"TEZ_BENCH_SORT_MB": "16", "TEZ_BENCH_SORT_IOSORT_MB": "1",
                 "TEZ_BENCH_SORT_MERGE_MB": "16"}.items():
        monkeypatch.setenv(k, v)
    rec = sort_bench.bench_sort(device="cpu")
    assert rec["metric"].endswith("outputs bit-identical) on cpu")
    assert "SHUFFLE_PUSH_BYTES=0" not in rec["metric"]
    assert rec["unit"] == "MB/s" and rec["min_vs_baseline"] == 1.2


@pytest.mark.parametrize("engine", ["host", "device"])
def test_spill_bench_run_matches_tez_tpu(tmp_staging, engine):
    """tests/test_ordered_shuffle_e2e.py:202's run: the output verified
    against the streamed golden and the proxy in both packages, the same
    counters and distinct words."""
    rec = spill_bench.run(target_mb=6, vocab=60_000, sort_mb=1,
                          engine=engine, parallelism=2, device="cpu")
    jrec = jspill_bench.run(target_mb=6, vocab=60_000, sort_mb=1,
                            engine=engine, parallelism=2)
    c = rec["counters"]
    assert c.get("SPILLED_RECORDS", 0) > 0
    assert c.get("ADDITIONAL_SPILLS_BYTES_WRITTEN", 0) > 0
    assert c.get("ADDITIONAL_SPILLS_BYTES_READ", 0) > 0
    assert c == jrec["counters"]
    assert rec["distinct_words"] == jrec["distinct_words"] > 0
    assert rec["device"] == "cpu" and "jax_backend" not in rec
    assert rec["engine_resolved"] == jrec["engine_resolved"]
    assert rec["proxy_seconds"] > 0 and rec["vs_baseline"] > 0


def test_spill_bench_corpus_matches_tez_tpu(tmp_path):
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    n, golden = spill_bench.make_corpus(str(a), 1, 5000, seed=4)
    jn, jgolden = jspill_bench.make_corpus(str(b), 1, 5000, seed=4)
    assert n == jn and np.array_equal(golden, jgolden)
    assert a.read_bytes() == b.read_bytes()
    out = tmp_path / "out"
    out.mkdir()
    (out / "part-00000").write_text("".join(
        f"w{i:04d}\t{c}\n" for i, c in enumerate(golden) if c))
    assert spill_bench.verify_output(str(out), golden) == \
        jspill_bench.verify_output(str(out), golden)
    golden[0] += 1
    with pytest.raises(AssertionError):
        spill_bench.verify_output(str(out), golden)


def test_spill_bench_main_writes_its_record(tmp_path, capsys):
    out = tmp_path / "rec.json"
    assert spill_bench.main(["--mb", "2", "--vocab-size", "20000",
                             "--sort-mb", "1", "--parallelism", "2",
                             "--device", "cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["counters"]["SPILLED_RECORDS"] > 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec


def test_harness_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for fn in (lambda: profile_kernels.profile(16),
               lambda: exchange_bench.bench_exchange(),
               lambda: sort_bench.bench_sort(),
               lambda: spill_bench.run(1, 100, 1, "auto", 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_bench_phase_on_the_host(tmp_path):
    """chip_smoke's phase 20 at TINY_BENCH on the CPU: every part runs and
    checks itself; no kernel launches off the card."""
    import types

    import chip_smoke
    args = types.SimpleNamespace(seed=0)
    corpus = chip_smoke.DagCorpus(
        str(tmp_path), args, marks_mb=(chip_smoke.TINY_BENCH["owc_mb"],),
        corpus_mb=2, vocab_size=20_000)
    out = chip_smoke.bench_phase(args, corpus, {}, device="cpu",
                                 **chip_smoke.TINY_BENCH)
    assert sorted(out["legs"]) == list("ABCDEFG")
    assert not any(out["launches"].values())
