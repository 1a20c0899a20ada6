"""CPU tests of the benchmark's harness: arguments, finding cells,
configurations, mixes and metric readers by name, agreement with
BENCHMARK.json, the result line, the refusal without a card, and that no
module of the benchmark loads JAX or the JAX package."""

from __future__ import annotations

import ast
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from benchmark import devtrace, harness
from benchmark.counts import rrdb as rrdb_counts
from benchmark.counts import swinir as swinir_counts
from benchmark.traffic import bulk

from .tiny_cells import tiny

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_parse_args():
    a = harness.parse_args(["--workload", "sr_bf16_bulk", "--seed", str(2**33 + 1),
                            "--seconds", "10", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("sr_bf16_bulk", 2**33 + 1, 10.0, 1)
    assert harness.parse_args(["--workload", "x", "--seed", "1", "--seconds", "2"]).trace == 0
    for bad in (["--seed", "1", "--seconds", "1"], ["--workload", "x", "--seed", "1"],
                ["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"],
                ["--workload", "x", "--seed", "-1", "--seconds", "1"],
                ["--workload", "x", "--seed", "1", "--seconds", "0"]):
        with pytest.raises(SystemExit):
            harness.parse_args(bad)


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name_matches_benchmark_json(name):
    cell = harness.load_cell(name)
    entry = next(w for w in SPEC["workloads"] if w["name"] == name)
    for key in ("config", "traffic", "chips", "why"):
        assert cell[key] == entry[key]
    cfg = next(c for c in SPEC["configs"] if c["name"] == cell["config"])
    assert cfg["file"] == f"benchmark/configs/{cell['config']}.toml"
    assert cell["cfg"]["source"] == cfg["source"] and cell["cfg"]["reduced"] == cfg["reduced"]
    for kind in ("programs", "reference", "counts"):
        assert harness.module(kind, cell["cfg"]["family"])
    assert harness.module("traffic", cell["mix"]["kind"])
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if name in m.get("workloads", CELLS)]
    assert sorted(cell["end_to_end"]) == sorted(e2e)
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        harness.load_cell("no_such_cell")
    with pytest.raises(FileNotFoundError):
        harness.module("metrics", "no_such_metric")


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_by_name_declares_what_benchmark_json_says(metric):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == metric)
    reader = harness.module("metrics", metric)
    assert reader.NAME == metric
    for key in ("unit", "better", "source", "layer", "moves"):
        assert getattr(reader, key.upper()) == entry[key]
    listed = [c for c in CELLS if metric in harness.load_cell(c)["per_layer"]]
    assert sorted(listed) == sorted(entry["workloads"])
    assert reader.read({"cfg": harness.load_cell(listed[0])["cfg"]}) is None  # nothing to read


def test_every_configuration_is_used_and_has_its_file():
    used = {harness.load_cell(c)["config"] for c in CELLS}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert (harness.ROOT / c["file"]).is_file()


def test_result_line_shape(monkeypatch):
    """`main` prints the check lines last on stderr and one JSON object last
    on stdout, its keys in the order the result line fixes, `check` last."""
    cell = tiny("sr_bf16_bulk")
    monkeypatch.setattr(harness, "require_cards", lambda n: None)
    monkeypatch.setattr(harness, "load_cell", lambda name: cell)
    real = harness.execute
    monkeypatch.setattr(harness, "execute",
                        lambda c, s, sec, tr, t_start=None: real(c, s, sec, tr, device="cpu"))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = harness.main(["--workload", "sr_bf16_bulk", "--seed", str(2**34 + 5),
                           "--seconds", "0.2"], 0.0)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 4
    assert set(line["metrics"]) == {"images_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    tail = err.getvalue().strip().splitlines()[-len(line["check"]):]
    assert [t.split()[1] for t in tail] == list(line["check"])


def test_no_result_when_a_forbidden_module_is_loaded(monkeypatch):
    cell = tiny("sr_bf16_bulk")
    monkeypatch.setattr(harness, "require_cards", lambda n: None)
    monkeypatch.setattr(harness, "load_cell", lambda name: cell)
    real = harness.execute

    def execute(c, s, sec, tr, t_start=None):
        monkeypatch.setitem(sys.modules, "flax", sys)  # loaded by something in the run
        return real(c, s, sec, tr, device="cpu", log=lambda *a, **k: None)

    monkeypatch.setattr(harness, "execute", execute)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = harness.main(["--workload", "sr_bf16_bulk", "--seed", "9", "--seconds", "0.1"], 0.0)
    assert rc == 3 and out.getvalue() == "" and "flax" in err.getvalue()


def test_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload",
                           "sr_bf16_bulk", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def _imported_top_levels(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(node.args[0].value.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax():
    files = sorted(harness.BENCH.rglob("*.py"))
    assert files
    for f in files:
        found = _imported_top_levels(f) & set(harness.FORBIDDEN)
        assert not found, f"{f.relative_to(harness.ROOT)} imports {found}"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "xmm_superres_denoise_torch_fake", sys)
    assert "xmm_superres_denoise_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_a_run_loads_no_forbidden_module():
    """In a fresh process, what a run imports (the harness, every family's
    program, reference and counts, every reader) holds none of them."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from benchmark import harness, calibrate;"
        "[harness.module(k, f) for k in ('programs', 'reference', 'counts') for f in ('rrdb', 'swinir')];"
        "[harness.module('metrics', p.stem) for p in (harness.BENCH / 'metrics').glob('*.py')];"
        "import xmm_superres_denoise_torch.infer.run_file, xmm_superres_denoise_torch.utils.weights;"
        "print(harness.forbidden_modules())"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(harness.ROOT)], capture_output=True,
                          text=True, timeout=120, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_pool_is_seeded_and_sized():
    mix = tiny("sr_bf16_bulk")["mix"]
    a, b = bulk.make_pool(mix, 2**33 + 3, "cpu"), bulk.make_pool(mix, 2**33 + 3, "cpu")
    assert a.shape == (6, 24, 22) and a.dtype == np.float32
    assert np.array_equal(a, b) and not np.array_equal(a, bulk.make_pool(mix, 4, "cpu"))
    counts = a * mix["exposure_s"]
    assert np.allclose(counts, np.round(counts), atol=1e-3) and counts.min() >= 0


def test_window_ends_with_the_call_past_its_length_and_keeps_seeded_outputs():
    mix = dict(pool=5, call_images=2)
    pool = np.arange(5 * 3 * 3, dtype=np.float32).reshape(5, 3, 3)
    seen = []

    def serve(stack):
        seen.append(stack[:, 0, 0].tolist())
        return stack * 2, stack + 1

    win = bulk.run_window(serve, pool, mix, float("inf"), 1, np.random.default_rng(0),
                          max_calls=3)
    assert seen == [[0, 9], [18, 27], [36, 0]]  # wraps around the pool
    assert win["attempted"] == 6 and win["failed"] == 0 and len(win["kept"]) == 3
    for i, pred, inp in win["kept"]:
        assert np.array_equal(pred, pool[i] * 2) and np.array_equal(inp, pool[i] + 1)
    one = bulk.run_window(serve, pool, mix, 0.0, 1, np.random.default_rng(0))
    assert len(one["calls"]) == 1 and one["metrics"]["images_per_s"]["value"] > 0


def test_trace_reduction():
    ev = [("bench.trace_window", False, 0.0, 100.0), ("cudaLaunchKernel", False, 5.0, 12.0),
          ("aten::copy_", False, 50.0, 70.0), ("k_a", True, 10.0, 30.0),
          ("k_b", True, 20.0, 40.0), ("Memcpy DtoH", True, 75.0, 90.0),
          ("k_a", True, 95.0, 120.0), ("outside", True, 130.0, 140.0)]
    r = devtrace.reduce(ev, "bench.trace_window")
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx((30 + 15 + 5) * 1e-6)
    assert dict(r["device_ops"]) == pytest.approx({"k_a": 25e-6, "k_b": 20e-6,
                                                   "Memcpy DtoH": 15e-6})
    assert dict(r["idle_gaps"]) == pytest.approx({"cudaLaunchKernel": 10e-6,
                                                  "aten::copy_": 35e-6,
                                                  "host outside any traced event": 5e-6})


def test_readers_on_a_synthetic_trace():
    cfg = harness.load_cell("sr_bf16_bulk")["cfg"]
    trace = {"window_s": 1.0, "busy_s": 0.8,
             "ops": [("void conv3x3_wgmma32::kernel<1>", 0.0, 0.5), ("elementwise_kernel", 0.5, 0.6),
                     ("Memcpy HtoD", 0.6, 0.7)]}
    ctx = {"cfg": cfg, "trace": trace, "traced_images": 256, "images_per_s": 300.0,
           "ops_per_image": rrdb_counts.forward_ops(cfg), "forward_ms_per_image": 2.5,
           "run_tiles_ms_per_image": 3.2}
    read = {m: harness.module("metrics", m).read(ctx) for m in
            ("k2_roofline", "idle_share", "mfu", "engine.forward_share",
             "zoo.elementwise_ms_per_image")}
    least = 256 * 12 * rrdb_counts.dense_block_ops(416, 416, 32) / 989e12
    assert read["k2_roofline"] == pytest.approx(100 * least / 0.5)
    assert read["idle_share"] == pytest.approx(20.0)
    assert read["mfu"] == pytest.approx(100 * 603.364589568e9 * 300 / 989e12)
    assert read["engine.forward_share"] == pytest.approx(100 * 2.5 / 3.2)
    assert read["zoo.elementwise_ms_per_image"] == pytest.approx(1e3 * 0.1 / 256)
    swin = dict(ctx, cfg=harness.load_cell("swinir_bf16_bulk")["cfg"])
    assert harness.module("metrics", "k2_roofline").read(swin) is None


def test_rrdb_operation_count():
    cfg = harness.load_cell("sr_bf16_bulk")["cfg"]
    blocks = 12 * rrdb_counts.dense_block_ops(416, 416, 32)
    assert blocks == 12 * 2 * 416 * 416 * 9 * 32 * (32 + 64 + 96 + 128 + 160)
    assert round(blocks / 1e9) == 574
    assert round(rrdb_counts.forward_ops(cfg) / 1e9) == 603
    assert rrdb_counts.dense_block_bytes(416, 416, 32, 2) == 2 * (2 * 416 * 416 * 32 + sum(
        9 * k * 32 * 32 + 32 for k in range(1, 6)))


def test_swinir_operation_count_and_flop_counter():
    cfg = harness.load_cell("swinir_bf16_bulk")["cfg"]
    assert round(swinir_counts.forward_ops(cfg) / 1e10) == 640
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import swinir

    small = dict(cfg, lr_res=26, hr_res=52, depths=[2, 2], num_heads=[6, 6])
    w = {k: torch.empty(s, device="meta") for k, s, _ in swinir.param_shapes(small)}
    with FlopCounterMode(display=False) as counter:
        swinir.model(w, torch.empty(1, 26, 26, 1, device="meta"), small)
    assert counter.get_total_flops() == swinir_counts.forward_ops(small)
