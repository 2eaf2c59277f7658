"""The port's slice as a whole: chip_smoke.py's ordered edge (producers ->
merge_sorted_runs) at a small size on device="cpu", against the same
composition in tez_tpu, with producer runs also carried across by
Run.from_arrays; plus the import guard (no JAX, no tez_tpu module) and
chip_smoke.py's refusal to run without a card."""
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import chip_smoke
from tez_tpu.ops import sorter as jsorter
from tez_tpu.ops.runformat import KVBatch as JBatch
from tez_tpu_torch.ops import sorter as tsorter
from tez_tpu_torch.ops.runformat import Run as TRun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAN = 96 << 10


def _same(t, j):
    for a, b in ((t.batch.key_bytes, j.batch.key_bytes),
                 (t.batch.key_offsets, j.batch.key_offsets),
                 (t.batch.val_bytes, j.batch.val_bytes),
                 (t.batch.val_offsets, j.batch.val_offsets),
                 (t.row_index, j.row_index)):
        np.testing.assert_array_equal(a, b)


def _jax_produce(producer_batches, key_width, combiner):
    runs = []
    for batches in producer_batches:
        s = jsorter.DeviceSorter(
            num_partitions=chip_smoke.NUM_PARTITIONS, key_width=key_width,
            span_budget_bytes=SPAN, engine="device", combiner=combiner,
            device_min_records=0)
        for b in batches:
            s.write_batch(JBatch(b.key_bytes, b.key_offsets, b.val_bytes,
                                 b.val_offsets))
        runs.append(s.flush())
    return runs


def _carry(run):
    b = run.batch
    return TRun.from_arrays(b.key_bytes, b.key_offsets, b.val_bytes,
                            b.val_offsets, run.row_index, device="cpu")


@pytest.mark.parametrize("leg", ["bench", "combiner"])
def test_ordered_edge_matches_tez_tpu(leg):
    rng = np.random.default_rng(21)
    if leg == "bench":
        vocab = chip_smoke.bench_vocab()
        rec = chip_smoke.span_records(SPAN)
        producer_batches = [[chip_smoke.bench_batch(rng, vocab, rec)[0]
                             for _ in range(2)] for _ in range(3)]
        key_width, tcomb, jcomb = 12, None, None
    else:
        _words, mat, lens = chip_smoke.word_vocab(rng, size=3000)
        producer_batches = [[chip_smoke.word_batch(rng, mat, lens, SPAN)[0]
                             for _ in range(2)] for _ in range(3)]
        key_width = 16
        tcomb, jcomb = tsorter.sum_long_combiner, jsorter.sum_long_combiner
    truns = chip_smoke.produce(producer_batches, key_width, SPAN,
                               combiner=tcomb, device="cpu",
                               device_min_records=0)
    jruns = _jax_produce(producer_batches, key_width, jcomb)
    for t, j in zip(truns, jruns):
        _same(t, j)
    want = jsorter.merge_sorted_runs(jruns, chip_smoke.NUM_PARTITIONS,
                                     key_width, device_min_records=0)
    for runs in (truns, [_carry(r) for r in jruns]):
        got = tsorter.merge_sorted_runs(runs, chip_smoke.NUM_PARTITIONS,
                                        key_width, device_min_records=0,
                                        device="cpu")
        _same(got, want)
    if leg == "combiner":
        _same(tsorter.sum_long_combiner(got), jsorter.sum_long_combiner(want))


def test_slice_phases_check_their_goldens_on_the_host():
    """chip_smoke's phases 3-6 at a small size with the plain versions: the
    goldens agree and every phase's check passes."""
    args = type("Args", (), {"seed": 3, "producers": 2, "span_mb": 0.25})
    launches = chip_smoke.slice_phases(args, device="cpu")
    assert launches == {"fnv_hash_bytes": 0, "fnv_hash_lanes": 0,
                        "merge_rank": 0, "merge_path_pair": 0}


def test_containment_phase_on_the_host():
    """chip_smoke's phase 7 at a small size with the plain versions: each
    fault run flushes the fault-free bytes and moves its counters (a 20 s
    hang against the 500 ms watchdog, so the bound is checked too)."""
    args = type("Args", (), {"seed": 5})
    launches = chip_smoke.containment_phase(args, device="cpu",
                                            hang_ms=20_000, span_mb=2.5)
    assert launches == {"fnv_hash_bytes": 0, "fnv_hash_lanes": 0,
                        "merge_rank": 0, "merge_path_pair": 0}


def test_import_guard_no_jax_no_tez_tpu():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import importlib, pkgutil
        import tez_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            tez_tpu_torch.__path__, "tez_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        # every package of the port, and the modules of this slice
        for name in ("api.events", "am.edge", "runtime.task_runner",
                     "shuffle.service", "store.lineage", "library.inputs",
                     "library.outputs", "ops.sorter", "dag.dag",
                     "client.tez_client", "am.app_master", "am.launcher",
                     "library.vertex_managers", "io.text",
                     "io.file_output", "examples.ordered_wordcount",
                     "shuffle.server", "shuffle.scheduler",
                     "shuffle.native_server", "am.umbilical_server",
                     "runtime.remote_runner", "common.tls",
                     "common.security", "library.test_components",
                     "parallel", "parallel.mesh", "parallel.exchange",
                     "parallel.coordinator", "library.unordered",
                     "library.mesh_io", "examples.wordcount",
                     "examples.simple_session", "examples.mrr",
                     "store", "store.buffer_store", "shuffle.push",
                     "am.cluster_binding", "am.client_server",
                     "client.remote", "am.recovery", "query",
                     "query.logical", "query.feedback", "query.planner",
                     "query.processors", "query.session", "tools",
                     "tools.query_corpus", "examples.sort_merge_join",
                     "examples.hash_join", "examples.cartesian_product",
                     "examples.driver", "library.cartesian_product",
                     "library.fair_shuffle", "am.streaming",
                     "library.streaming", "am.speculation",
                     "am.estimators", "obs.slo", "obs.exposition",
                     "common.lockorder", "common.dispatcher",
                     "am.task_scheduler", "common.metrics", "version",
                     "ops.keycodec", "ops.native", "tools.bench_diff",
                     "tools.profile_kernels", "tools.exchange_bench",
                     "tools.sort_bench", "tools.spill_bench",
                     "tools.history_parser", "tools.trace_export",
                     "tools.doctor", "tools.query_bench"):
            assert "tez_tpu_torch." + name in names, name
        # a DAG through the port resolves every descriptor string it
        # carries (a string naming tez_tpu would load it here)
        import os, tempfile
        from tez_tpu_torch.examples import ordered_wordcount
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "in.txt"), "w") as fh:
                fh.write("b a b\\nc b a\\n" * 50)
            # runner processes import neither: their sitecustomize blocks
            # both names, so a task that reached one would fail the DAG
            guard = os.path.join(d, "guard")
            os.makedirs(guard)
            with open(os.path.join(guard, "sitecustomize.py"), "w") as fh:
                fh.write("import sys\\n"
                         "sys.modules['jax'] = None\\n"
                         "sys.modules['tez_tpu'] = None\\n")
            for mode, runners in (("simple", "threads"),
                                  ("vector", "threads"),
                                  ("vector", "subprocess")):
                out = os.path.join(d, "out_" + mode + "_" + runners)
                state = ordered_wordcount.run(
                    [os.path.join(d, "in.txt")], out,
                    conf={"tez.staging-dir": os.path.join(d, "stg"),
                          "tez.runner.mode": runners,
                          "tez.am.runner.env": {"PYTHONPATH": guard}},
                    device="cpu", tokenizer_mode=mode)
                assert state == "SUCCEEDED", state
                with open(os.path.join(out, "part-00000")) as fh:
                    assert fh.read() == "c\\t50\\na\\t100\\nb\\t150\\n"
            # the unordered edge and the mesh exchange resolve too
            from tez_tpu_torch.examples import wordcount
            out = os.path.join(d, "out_wc")
            assert wordcount.run([os.path.join(d, "in.txt")], out,
                                 conf={"tez.staging-dir":
                                       os.path.join(d, "stg")},
                                 device="cpu") == "SUCCEEDED"
            out = os.path.join(d, "out_mesh")
            assert ordered_wordcount.run(
                [os.path.join(d, "in.txt")], out,
                conf={"tez.staging-dir": os.path.join(d, "stg")},
                device="cpu", exchange="mesh") == "SUCCEEDED"
            with open(os.path.join(out, "part-00000")) as fh:
                assert fh.read() == "c\\t50\\na\\t100\\nb\\t150\\n"
        bad = [m for m in sys.modules
               if m == "tez_tpu" or m.startswith("tez_tpu.")
               or m == "jax" or m.startswith("jax.")]
        assert bad == ["jax"], bad   # only the blocked placeholder
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(lone), str(tmp_path))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_merge_rank_turns_loads_each_checkout_apart(tmp_path):
    """kernel_turns.py loads another checkout's package beside this
    one: each kernels module builds and binds through its own tree, and
    the caller's modules are back in place afterwards.  Without a card the
    script itself exits non-zero before timing anything."""
    other = tmp_path / "other"
    shutil.copytree(os.path.join(REPO, "tez_tpu_torch"),
                    other / "tez_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = textwrap.dedent(f"""
        import sys
        import numpy as np, torch
        import chip_smoke, kernel_turns as mt
        import tez_tpu_torch.ops.kernels as mine
        trees = [mt.load_kernels({REPO!r}), mt.load_kernels({str(other)!r})]
        assert sys.modules["tez_tpu_torch.ops.kernels"] is mine
        rng = np.random.default_rng(0)
        run = chip_smoke.sorted_run(rng, 3000, 3)
        t, _, _ = chip_smoke.rank_tensors(
            run, chip_smoke.random_queries(rng, run, 2000, 3), "cpu")
        want = mine._rank_search(*t, True)
        for root, (kernels, mods) in zip(({REPO!r}, {str(other)!r}), trees):
            assert kernels.__file__.startswith(root)
            with mt.installed(mods):
                from tez_tpu_torch.ops import _build
                assert _build.__file__.startswith(root)
                assert torch.equal(kernels.merge_rank(*t, True), want)
        assert trees[0][0] is not trees[1][0] is not mine
        assert sys.modules["tez_tpu_torch.ops.kernels"] is mine
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, "kernel_turns.py",
                              "merge_rank", str(other)], cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert "kernel_turns" not in out.stdout


def test_fnv_sweep_inputs_and_turns_without_a_card():
    """Phase 2's FNV sweep names the widths the kernel templates and one
    it reads at run time, the modulo's three routes, a short last tile,
    unaligned bases and one row; fnv_inputs draws lengths in -1..W and,
    for a view, the rows from row 1 of a longer matrix; kernel_turns.py
    names both kernels, imports neither JAX nor tez_tpu and, without a
    card, exits non-zero before timing anything."""
    cases = {c[0]: c[1:] for c in chip_smoke.FNV_SWEEP}
    assert {w for _, w, _, _ in cases.values()} >= {4, 8, 12, 16, 32, 64}
    assert {p for _, _, p, _ in cases.values()} >= {
        chip_smoke.NUM_PARTITIONS, 8, 7, 2 ** 31 - 1}
    assert cases["tail"][0] % 1024 and cases["N=1"][0] == 1
    assert cases["view"][3] and cases["view"][1] % 16
    g = torch.Generator().manual_seed(0)
    mat, lens = chip_smoke.fnv_inputs(g, 5000, 12, "cpu", view=True)
    assert mat.shape == (5000, 12) and mat.storage_offset() == 12
    assert lens.shape == (5000,) and lens.storage_offset() == 1
    assert mat.is_contiguous() and lens.is_contiguous()
    assert int(lens.min()) == -1 and int(lens.max()) == 12
    if torch.cuda.is_available():
        return
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["tez_tpu"] = None
        import kernel_turns
        assert set(kernel_turns.KERNELS) == {"merge_rank", "fnv_hash_bytes"}
        sys.exit(kernel_turns.main(["fnv_hash_bytes", "."]))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "kernel_turns" not in out.stdout
