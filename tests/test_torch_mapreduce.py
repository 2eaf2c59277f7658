"""Port parity of the MapReduce layer and the fixed-width format
(tez_tpu_torch/io/mapreduce.py, tez_tpu_torch/io/formats.py
FixedWidthKVFormat and MultiMRInput, tez_tpu_torch/examples/mr_jobs.py)
against tez_tpu's, on the CPU: tez_tpu on JAX's CPU backend, the port with
device="cpu".

Every case of tests/test_mapreduce_compat.py runs on the port with the same
checks, and each job also runs through tez_tpu over the same seeded input:
the part files are equal byte for byte.  Both packages run the same user
code (tez_tpu_torch/examples/mr_jobs.py, importable by a runner process).
The split lists of FixedWidthKVFormat.compute_splits (trailing partial
records included), MultiMRInput's readers, the DAG plans the builders and
mr_job_to_dag make (package prefix mapped) and mr_job_to_dag's validation
errors are equal too.  Last, chip_smoke's phase 21 at TINY_MR.
"""
import collections
import importlib
import os
import struct

import numpy as np
import pytest

from test_torch_query import names_tez_tpu, plan_tree

ROOTS = ("tez_tpu_torch", "tez_tpu")
PORT = ROOTS[0]
JOBS = "tez_tpu_torch.examples.mr_jobs:"


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def _fresh_planes():
    def reset():
        for root in ROOTS:
            mod(root, "store").reset_store()
            mod(root, "common.epoch").reset()
            mod(root, "common.faults").clear_all()
            mod(root, "ops.async_stage").reset_process_breaker()
    reset()
    yield
    reset()


def run_dag(root: str, dag, tmp_path, timeout: float = 120) -> str:
    """dag through root's TezClient (the port's on the CPU); its final
    state's name."""
    kw = {"device": "cpu"} if root == PORT else {}
    client = mod(root, "client.tez_client").TezClient.create(
        dag.name, {"tez.staging-dir": str(tmp_path / root / "staging"),
                   "tez.am.local.num-containers": 4}, **kw)
    with client as c:
        return c.submit_dag(dag).wait_for_completion(
            timeout=timeout).state.name


def part_files(out: str) -> dict:
    return {f: open(os.path.join(out, f), "rb").read()
            for f in sorted(os.listdir(out)) if f.startswith("part-")}


def text_rows(out: str) -> dict:
    got = {}
    for data in part_files(out).values():
        for line in data.decode().splitlines():
            k, v = line.split("\t")
            got[k] = int(v)
    return got


def both(tmp_path, build) -> dict:
    """build(root, out) -> DAG, run in both packages: {root: part files};
    the part files must be equal byte for byte."""
    parts = {}
    for root in ROOTS:
        out = str(tmp_path / root / "out")
        assert run_dag(root, build(root, out), tmp_path) == "SUCCEEDED", root
        parts[root] = part_files(out)
        assert os.path.exists(os.path.join(out, "_SUCCESS")), root
    assert parts[PORT] == parts["tez_tpu"]
    return parts


# -- tests/test_mapreduce_compat.py on the port, each against tez_tpu -------
def test_simple_mr_wordcount(tmp_path):
    corpus = tmp_path / "in.txt"
    corpus.write_text("x y z x y x\n" * 100)

    def build(root, out):
        return mod(root, "io.mapreduce").simple_mr_dag(
            "mr-wc", [str(corpus)], out, map_fn=JOBS + "wc_map_long",
            reduce_fn=JOBS + "wc_reduce", num_mappers=2, num_reducers=2,
            key_serde="text", value_serde="text")

    both(tmp_path, build)
    assert text_rows(str(tmp_path / PORT / "out")) == \
        {"x": 300, "y": 200, "z": 100}


def test_fixed_width_binary_format_e2e(tmp_path):
    data = tmp_path / "in.bin"
    golden = collections.Counter()
    with open(data, "wb") as fh:
        for i in range(5000):
            key = f"b{i % 7}_{i:04d}".encode()[:8].ljust(8, b"\x00")
            count = i % 13
            golden[key[:2]] += count
            fh.write(key + struct.pack(">q", count))

    def build(root, out):
        return mod(root, "io.mapreduce").simple_mr_dag(
            "mr-fixed", [str(data)], out, map_fn=JOBS + "fixed_map",
            reduce_fn=JOBS + "fixed_reduce", num_mappers=3, num_reducers=2,
            key_serde="text", value_serde="text", input_format="fixed",
            format_params={"key_bytes": 8, "value_bytes": 8})

    both(tmp_path, build)
    got = {k.encode(): v for k, v in
           text_rows(str(tmp_path / PORT / "out")).items()}
    assert got == dict(golden)


@pytest.mark.parametrize("size,key_bytes,value_bytes,desired,min_split", [
    (12 * 1000 + 5, 4, 8, 4, 64),         # the oracle's case
    (100 * 3001 + 99, 10, 90, 4, 1024),   # TeraSort records, a partial tail
    (100 * 4096, 10, 90, 7, 4096),        # no tail, uneven splits
    (17 * 500 + 16, 1, 16, 3, 64),
    (5, 4, 8, 2, 64),                     # smaller than one record
])
def test_fixed_width_splits_match_tez_tpu(tmp_path, size, key_bytes,
                                         value_bytes, desired, min_split):
    """The oracle's record-alignment checks on the port, and the split
    lists equal tez_tpu's (the trailing partial record dropped)."""
    rec = key_bytes + value_bytes
    rng = np.random.default_rng(size)
    paths = []
    for i in range(2):
        p = tmp_path / f"{i}.bin"
        p.write_bytes(rng.integers(0, 256, size + i * rec,
                                   dtype=np.uint8).tobytes())
        paths.append(str(p))
    splits = {}
    for root in ROOTS:
        fmt = mod(root, "io.formats").FixedWidthKVFormat(
            {"key_bytes": key_bytes, "value_bytes": value_bytes})
        splits[root] = [(s.path, s.start, s.length) for s in
                        fmt.compute_splits(paths, desired,
                                           min_split_bytes=min_split)]
    assert splits[PORT] == splits["tez_tpu"]
    for path in paths:
        mine = sorted((s, n) for p, s, n in splits[PORT] if p == path)
        assert all(s % rec == 0 and n % rec == 0 for s, n in mine)
        assert sum(n for _s, n in mine) == \
            os.path.getsize(path) // rec * rec
        ends = 0
        for s, n in mine:
            assert s == ends
            ends = s + n


def test_fixed_width_rejects_bad_widths():
    for root in ROOTS:
        fmt = mod(root, "io.formats").FixedWidthKVFormat(
            {"key_bytes": 0, "value_bytes": 8})
        with pytest.raises(ValueError, match="bad fixed-width record"):
            fmt.open([], None)


class _Ctx:
    def __init__(self, root, payload):
        self._payload = payload
        self.counters = mod(root, "common.counters").TezCounters()
        self.user_payload = self

    def load(self):
        return self._payload

    def notify_progress(self):
        pass


def _multi_input(root, payload):
    cls = mod(root, "io.formats").MultiMRInput
    inp = cls.__new__(cls)
    inp.context = _Ctx(root, payload)
    inp.initialize()
    return inp


def test_multi_mr_input_one_reader_per_split(tmp_path):
    """The oracle's text case on the port, and per-split readers over
    fixed-width records equal tez_tpu's with the same counters."""
    f1 = tmp_path / "a.txt"
    f1.write_text("a1\na2\n")
    f2 = tmp_path / "b.txt"
    f2.write_text("b1\n")
    rng = np.random.default_rng(3)
    f3 = tmp_path / "c.bin"
    f3.write_bytes(rng.integers(0, 256, 16 * 301 + 7,
                                dtype=np.uint8).tobytes())
    got = {}
    for root in ROOTS:
        split = mod(root, "io.text").FileSplit
        text = {"format": "text", "static_splits": [
            split(str(f1), 0, f1.stat().st_size),
            split(str(f2), 0, f2.stat().st_size)]}
        readers = _multi_input(root, text).get_key_value_readers()
        assert len(readers) == 2
        assert [line for _, line in readers[0]] == [b"a1", b"a2"]
        assert [line for _, line in readers[1]] == [b"b1"]
        assert [line for _, line in
                _multi_input(root, text).get_reader()] == \
            [b"a1", b"a2", b"b1"]
        fmt = mod(root, "io.formats").FixedWidthKVFormat(
            {"key_bytes": 6, "value_bytes": 10})
        fixed = {"format": "fixed",
                 "format_params": {"key_bytes": 6, "value_bytes": 10},
                 "static_splits": fmt.compute_splits([str(f3)], 3,
                                                     min_split_bytes=64)}
        inp = _multi_input(root, fixed)
        per_split = [list(r) for r in inp.get_key_value_readers()]
        assert len(per_split) == len(fixed["static_splits"]) > 1
        got[root] = (per_split,
                     [(s.start, s.length) for s in fixed["static_splits"]],
                     inp.context.counters.to_dict())
    assert got[PORT] == got["tez_tpu"]
    data = f3.read_bytes()
    flat = [kv for split in got[PORT][0] for kv in split]
    assert flat == [(data[o:o + 6], data[o + 6:o + 16])
                    for o in range(0, len(data) - 15, 16)]


def test_split_wave_grouping_keys(tmp_path):
    data = tmp_path / "in.txt"
    data.write_bytes(b"x" * (1 << 20))
    counts = {}
    for root in ROOTS:
        gen_cls = mod(root, "io.formats").MRSplitGenerator
        user_payload = mod(root, "common.payload").UserPayload

        class Ctx:
            num_tasks = -1

            def __init__(self, payload):
                self.user_payload = user_payload.of(payload)

            def get_total_available_resource(self):
                return 4

        class Gen(gen_cls):
            def __init__(self, payload):
                self.context = Ctx(payload)

        def group_count(payload):
            return Gen(payload).initialize()[0].num_tasks

        base = {"paths": [str(data)], "min_split_bytes": 1024}
        counts[root] = [
            group_count(dict(base)),
            group_count({**base, "tez.grouping.min-size": 1024}),
            group_count({**base, "tez.grouping.min-size": 1024,
                         "tez.grouping.split-waves": 1.0}),
            group_count({**base, "tez.grouping.min-size": 1,
                         "tez.grouping.max-size": 64 * 1024})]
    assert counts[PORT] == [1, 6, 4, 16] == counts["tez_tpu"]


def test_counter_limits_configurable():
    for root in ROOTS:
        limits = mod(root, "common.counters").Limits
        before = (limits.MAX_COUNTERS, limits.MAX_GROUPS)
        try:
            limits.configure({"tez.counters.max": 7,
                              "tez.counters.max.groups": 3})
            assert (limits.MAX_COUNTERS, limits.MAX_GROUPS) == (7, 3)
        finally:
            limits.MAX_COUNTERS, limits.MAX_GROUPS = before


def test_svm_descriptor_from_conf():
    trees = {}
    for root in ROOTS:
        svm = mod(root, "library.vertex_managers").ShuffleVertexManager
        d = svm.create_descriptor(
            {"tez.shuffle-vertex-manager.min-src-fraction": 0.5,
             "tez.shuffle-vertex-manager.enable.auto-parallel": True},
            min_task_parallelism=2)
        p = d.payload.load()
        assert p["min_fraction"] == 0.5 and p["auto_parallel"] is True
        assert p["max_fraction"] == 0.75 and p["min_task_parallelism"] == 2
        assert "ShuffleVertexManager" in d.class_name
        assert d.class_name.startswith(root + ".")
        trees[root] = plan_tree(d)
    assert trees[PORT] == trees["tez_tpu"]


def test_mr_chain_dag_three_stages(tmp_path):
    corpus = tmp_path / "in.txt"
    corpus.write_text("apple ant bee bear apple cat\n" * 50)

    def build(root, out):
        dag = mod(root, "io.mapreduce").mr_chain_dag(
            "mrr", [str(corpus)], out, map_fn=JOBS + "wc_map_long",
            reduce_fns=[JOBS + "count_pass_reduce",
                        JOBS + "fold_first_letter_reduce",
                        JOBS + "total_reduce"],
            num_mappers=2, num_reducers=[2, 2, 1],
            key_serde="text", value_serde="text")
        assert len(dag.vertices) == 4
        return dag

    both(tmp_path, build)
    assert text_rows(str(tmp_path / PORT / "out")) == \
        {"a": 150, "b": 100, "c": 50}


def _wc_conf(corpus, out) -> dict:
    return {
        "mapreduce.job.name": "conf-wc",
        "mapreduce.job.map.class": JOBS + "wc_map_long",
        "mapreduce.job.reduce.class": JOBS + "wc_reduce",
        "mapreduce.job.maps": 2,
        "mapreduce.job.reduces": 2,
        "mapreduce.input.fileinputformat.inputdir": str(corpus),
        "mapreduce.output.fileoutputformat.outputdir": out,
        "mapreduce.job.inputformat.class":
            "org.apache.hadoop.mapreduce.lib.input.TextInputFormat",
        "mapreduce.map.output.key.class": "org.apache.hadoop.io.Text",
        "mapreduce.map.output.value.class":
            "org.apache.hadoop.io.BytesWritable",
        "mapreduce.job.output.key.class": "org.apache.hadoop.io.Text",
        "mapreduce.job.output.value.class": "org.apache.hadoop.io.Text",
    }


def test_mr_job_conf_translation_e2e(tmp_path):
    corpus = tmp_path / "in.txt"
    corpus.write_text("x y z x y x\n" * 100)

    def build(root, out):
        dag = mod(root, "io.mapreduce").mr_job_to_dag(_wc_conf(corpus, out))
        assert dag.name == "conf-wc"
        return dag

    both(tmp_path, build)
    assert text_rows(str(tmp_path / PORT / "out")) == \
        {"x": 300, "y": 200, "z": 100}


def test_mr_job_conf_legacy_aliases_and_map_only(tmp_path):
    corpus = tmp_path / "in.txt"
    corpus.write_text("a b\nc d\n")

    def build(root, out):
        dag = mod(root, "io.mapreduce").mr_job_to_dag({
            "mapred.job.name": "legacy-ignored",
            "mapreduce.job.name": "maponly",
            "mapred.mapper.class": JOBS + "ident_map",
            "mapred.reduce.tasks": 0,
            "mapred.input.dir": str(corpus),
            "mapred.output.dir": out,
            "mapred.output.key.class": "org.apache.hadoop.io.Text",
            "mapred.output.value.class": "org.apache.hadoop.io.Text"})
        assert dag.name == "maponly" and len(dag.vertices) == 1
        return dag

    parts = both(tmp_path, build)
    words = [line.split(b"\t")[0] for data in parts[PORT].values()
             for line in data.splitlines()]
    assert sorted(words) == [b"a", b"b", b"c", b"d"]


@pytest.mark.parametrize("conf,match", [
    ({"mapreduce.job.reduces": 1}, "no mapper"),
    ({"mapreduce.job.map.class": "m:f"}, "input dir"),
    ({"mapreduce.job.map.class": "m:f",
      "mapreduce.input.fileinputformat.inputdir": "/x",
      "mapreduce.output.fileoutputformat.outputdir": "/y",
      "mapreduce.job.reduces": 2}, "no reducer"),
])
def test_mr_job_conf_validation(conf, match):
    errors = {}
    for root in ROOTS:
        with pytest.raises(ValueError, match=match) as err:
            mod(root, "io.mapreduce").mr_job_to_dag(conf)
        errors[root] = str(err.value)
    assert errors[PORT] == errors["tez_tpu"]


@pytest.mark.parametrize("builder", ["simple_text", "simple_fixed_multi",
                                     "chain", "conf", "conf_map_only",
                                     "conf_combiner"])
def test_plans_match_tez_tpu(tmp_path, builder):
    """Each builder's DAG plan equals tez_tpu's with the package prefix
    mapped, and no descriptor string of the port names a tez_tpu class."""
    out, path = str(tmp_path / "out"), str(tmp_path / "in")
    trees = {}
    for root in ROOTS:
        mr = mod(root, "io.mapreduce")
        if builder == "simple_text":
            dag = mr.simple_mr_dag("a", [path], out, JOBS + "wc_map_long",
                                   JOBS + "wc_reduce", num_mappers=3,
                                   num_reducers=2, key_serde="text")
        elif builder == "simple_fixed_multi":
            dag = mr.simple_mr_dag(
                "b", [path, path + "2"], out, JOBS + "identity_map",
                JOBS + "identity_reduce", num_mappers=4, num_reducers=4,
                input_format="fixed",
                format_params={"key_bytes": 10, "value_bytes": 90},
                multi_input=True)
        elif builder == "chain":
            dag = mr.mr_chain_dag(
                "c", [path], out, JOBS + "wc_map_long",
                [JOBS + "count_pass_reduce", JOBS + "total_reduce"],
                num_reducers=[3, 1], stage_serdes=[("bytes", "bytes"),
                                                   ("text", "bytes")])
        else:
            conf = _wc_conf(path, out)
            if builder == "conf_map_only":
                conf["mapred.reduce.tasks"] = 5
                conf["mapreduce.job.reduces"] = 0
            if builder == "conf_combiner":
                conf["mapred.combiner.class"] = "sum_long"
                conf["mapreduce.job.inputformat.class"] = \
                    JOBS + "TeraInputFormat"
            dag = mr.mr_job_to_dag(conf)
        plan = dag.create_dag_plan()
        trees[root] = plan_tree(plan)
        if root == PORT:
            assert names_tez_tpu(plan) == []
    assert trees[PORT] == trees["tez_tpu"]


def test_terasort_job_matches_tez_tpu(tmp_path):
    """TeraSort-shaped records (10-byte keys, 90-byte values, identity map
    and reduce, 4 x 4) through both packages, then through mr_job_to_dag
    with TeraInputFormat on the port: every part file equal; each part in
    key order and holding the records whose key's FNV partition it is."""
    import chip_smoke
    rng = np.random.default_rng(18)
    n = 3000
    recs = rng.integers(0, 256, (n, 100), dtype=np.uint8)
    path = tmp_path / "tera.bin"
    path.write_bytes(recs.tobytes() + b"\x07" * 37)  # a partial record

    def build(root, out):
        return mod(root, "io.mapreduce").simple_mr_dag(
            "terasort", [str(path)], out, map_fn=JOBS + "identity_map",
            reduce_fn=JOBS + "identity_reduce", num_mappers=4,
            num_reducers=4, input_format="fixed",
            format_params={"key_bytes": 10, "value_bytes": 90})

    parts = both(tmp_path, build)
    chip_smoke.check_terasort("terasort", str(tmp_path / PORT / "out"),
                              recs, 4)
    out = str(tmp_path / "conf_out")
    dag = mod(PORT, "io.mapreduce").mr_job_to_dag(
        chip_smoke.terasort_job_conf(str(path), out, 4, 4))
    assert run_dag(PORT, dag, tmp_path / "conf") == "SUCCEEDED"
    assert part_files(out) == parts[PORT]


def test_mr_phase_on_the_host():
    """chip_smoke's phase 21 at TINY_MR on the CPU: every check of the card
    run but the launch counts (the plain versions launch nothing)."""
    import types
    import chip_smoke
    out = chip_smoke.mr_phase(types.SimpleNamespace(seed=0), device="cpu",
                              **chip_smoke.TINY_MR)
    assert sorted(out["legs"]) == ["A", "B", "C", "D"]
    assert sum(out["launches"].values()) == 0
