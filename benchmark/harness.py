"""The benchmark's harness: one run of one cell, found by name.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is `workloads/<cell>.toml`, which names its configuration
(`configs/<config>.toml`), its traffic mix (`traffic/<mix>.toml`, whose
`kind` names the generator `traffic/<kind>.py`), its end-to-end and per-layer
metrics (`metrics/<name>.py`) and the limits of its comparison. A
configuration's `family` names the system under test
(`programs/<family>.py`), its plain reference (`reference/<family>.py`)
and its operation count (`counts/<family>.py`).

One run: set-up (imports, the card, the program with its weights, the
pool, one warm-up call of the cell's own shapes), then the measured window,
then with `--trace 1` a profiled window of whole calls and the forward
timed alone, then, with the program freed, the comparison of the window's
kept outputs with the reference. The last line of standard output is one
JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import sys
import time
import tomllib
from pathlib import Path
from types import ModuleType
from typing import Optional

import numpy as np

from . import check

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names the process must not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "xmm_superres_denoise_tpu")
FORWARD_CALLS = 3  # predict calls timed with CUDA events for engine.forward_share
REFERENCE_BLOCK = 4  # images per reference call


class NoCard(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def parse_args(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="cell name (workloads/<name>.toml)")
    p.add_argument("--seed", required=True, type=int, help="seeds the inputs and weights")
    p.add_argument("--seconds", required=True, type=float, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: report the per-layer metrics from a profiled window")
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must not be negative")
    if args.seconds <= 0:
        p.error("--seconds must be positive")
    return args


def _toml(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} not found")
    with open(path, "rb") as f:
        return tomllib.load(f)


def load_cell(name: str) -> dict:
    """The cell, its configuration and its traffic mix, by name."""
    cell = _toml(BENCH / "workloads" / f"{name}.toml")
    cell["name"] = name
    cell["cfg"] = _toml(BENCH / "configs" / f"{cell['config']}.toml")
    cell["mix"] = _toml(BENCH / "traffic" / f"{cell['traffic']}.toml")
    return cell


def module(kind: str, name: str) -> ModuleType:
    """`benchmark.<kind>.<name>`; a metric reader is loaded from its file,
    whose name may hold dots."""
    if kind != "metrics":
        return importlib.import_module(f"benchmark.{kind}.{name}")
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark runs on a CUDA card")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell asks for {n} cards; torch sees {torch.cuda.device_count()}")


def _span(name: str):
    import torch

    return torch.profiler.record_function(name)


def _sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize(device)


def _forward_ms_per_image(engine, pool: np.ndarray, batch: int, device: str) -> float:
    """CUDA-event ms per image of `engine.predict` on one prepared batch."""
    import torch

    with torch.inference_mode():
        x = engine.prepare(torch.from_numpy(pool[:batch]).to(device))
        engine.predict(x)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(FORWARD_CALLS):
            engine.predict(x)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / (FORWARD_CALLS * batch)


def _traced(serve, pool, cell, first_call: int, device: str) -> dict:
    """A profiled window of whole calls, reduced (`devtrace.reduce`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import devtrace

    gen = module("traffic", cell["mix"]["kind"])
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with _span("bench.trace_window"):
            gen.traced_window(serve, pool, cell["mix"], first_call, _span)
            torch.cuda.synchronize(device)
    return devtrace.reduce(devtrace.events_of(prof), "bench.trace_window")


def execute(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda:0",
            t_start: Optional[float] = None, log=print) -> dict:
    """One run of `cell`; returns the result object (without printing it)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cfg, mix, chk = cell["cfg"], cell["mix"], cell["check"]
    family = cfg["family"]
    program, reference = module("programs", family), module("reference", family)
    gen = module("traffic", mix["kind"])
    on_card = device.startswith("cuda")
    marks = {"imports": time.perf_counter() - t_start}

    engine = program.build(cfg, seed, ROOT, device)
    marks["program"] = time.perf_counter() - t_start
    pool = gen.make_pool(mix, seed, device)
    marks["pool"] = time.perf_counter() - t_start

    def serve(stack):
        return engine.run_tiles(stack, batch_size=cfg["batch_size"])

    serve(gen.call_stack(pool, mix, 0))  # warm-up: every shape of the window
    _sync(device)
    setup_s = time.perf_counter() - t_start
    marks["warm-up"] = setup_s
    log(f"[setup] {', '.join(f'{k} {v:.3f} s' for k, v in marks.items())}", file=sys.stderr)

    counted = getattr(program, "counters", None) if on_card else None
    before = counted() if counted else {}
    rng = np.random.default_rng([seed, 1])
    win = gen.run_window(serve, pool, mix, seconds, chk["keep_per_call"], rng)
    _sync(device)
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    launched = {k: v - before[k] for k, v in counted().items()} if counted else {}
    per_call = [e - s for s, e, _ in win["calls"]]
    log(f"[window] {len(per_call)} calls, {win['attempted']} images in {win['window_s']:.3f} s; "
        f"call s min {min(per_call):.4f} median {float(np.median(per_call)):.4f} "
        f"max {max(per_call):.4f}", file=sys.stderr)

    metrics = {}
    e2e = {"setup_s": {"value": setup_s, "unit": "s"}, **win["metrics"]}
    breakdown = None
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": memory_peak}
    if not trace:
        metrics = {k: e2e[k] for k in cell["end_to_end"]}
    else:
        n_calls = len(win["calls"])
        red = _traced(serve, pool, cell, n_calls, device)
        ctx = {
            "cfg": cfg, "trace": red, "images_per_s": e2e["images_per_s"]["value"],
            "traced_images": mix["trace_calls"] * mix["call_images"],
            "run_tiles_ms_per_image": 1e3 * win["window_s"] / max(1, win["attempted"]),
            "forward_ms_per_image": _forward_ms_per_image(engine, pool, cfg["batch_size"],
                                                          device),
            "ops_per_image": module("counts", family).forward_ops(cfg),
        }
        for name in cell["per_layer"]:
            reader = module("metrics", name)
            value = reader.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
        device_info.update(busy_s=red["busy_s"], window_s=red["window_s"])
        breakdown = {"device_ops": [[n, s] for n, s in red["device_ops"]],
                     "idle_gaps": [[n, s] for n, s in red["idle_gaps"]]}

    del engine, serve
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kept = win["kept"]
    take = np.random.default_rng([seed, 2]).permutation(len(kept))[: chk["sample"]]
    w = reference.weights(cfg, seed, ROOT, device)
    numbers = check.compare([kept[i] for i in sorted(take)], pool,
                            lambda r: reference.serve(w, r, cfg), REFERENCE_BLOCK, cfg, device)
    checked, ok = check.verdict(numbers, chk)
    if launched:  # exact counts: what the window's calls asked the kernels for
        chunks = -(-mix["call_images"] // cfg["batch_size"]) * len(win["calls"])
        for k, want in program.expected_counters(cfg, chunks).items():
            checked[k] = {"value": launched[k], "limit": want}
            ok = ok and launched[k] == want
    log(f"[check] {len(take)} images of {len(kept)} kept, reference {time.perf_counter() - t0:.3f} s",
        file=sys.stderr)
    result = {"correct": bool(ok and win["failed"] == 0),
              "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = checked
    return result


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    cell = load_cell(args.workload)
    try:
        require_cards(cell["chips"])
    except NoCard as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    found = forbidden_modules()  # everything this process loaded, the window long closed
    if found:
        print(f"error: modules loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
