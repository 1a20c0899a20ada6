#!/usr/bin/env python3
"""Readings that a cell's comparison limits are set from: on each seed,
the numbers of `check.py` for the program and for the control, over
`--calls` calls of the cell's own load, with the outputs kept and sampled
as a run keeps and samples them. One process, one card; one JSON line per
seed and side on standard output.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --calls 2 [--control]

The control is `programs/<family>.py: control`: the program's own path
below the configured precision where it has one (esr_gen: int8), else the
reference in float8; both prepare and post-process in bfloat16.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, harness  # noqa: E402


def readings(cell: dict, seed: int, calls: int, control: bool, device: str = "cuda:0") -> dict:
    """{"program": numbers[, "control": numbers]} on one seed."""
    cfg, mix, chk = cell["cfg"], cell["mix"], cell["check"]
    program = harness.module("programs", cfg["family"])
    reference = harness.module("reference", cfg["family"])
    gen = harness.module("traffic", mix["kind"])
    pool = gen.make_pool(mix, seed, device)

    def program_serve():
        engine = program.build(cfg, seed, harness.ROOT, device)
        return lambda stack: engine.run_tiles(stack, batch_size=cfg["batch_size"])

    sides = {"program": program_serve}
    if control:
        sides["control"] = lambda: program.control(cfg, seed, harness.ROOT, device)
    kept = {}
    for side, make in sides.items():  # one side on the card at a time
        win = gen.run_window(make(), pool, mix, float("inf"), chk["keep_per_call"],
                                np.random.default_rng([seed, 1]), max_calls=calls)
        kept[side] = win["kept"]
        del win
        gc.collect()
        torch.cuda.empty_cache()
    w = reference.weights(cfg, seed, harness.ROOT, device)
    out = {}
    for side, k in kept.items():
        take = np.random.default_rng([seed, 2]).permutation(len(k))[: chk["sample"]]
        out[side] = check.compare([k[i] for i in sorted(take)], pool,
                                  lambda r: reference.serve(w, r, cfg),
                                  harness.REFERENCE_BLOCK, cfg, device)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--calls", type=int, default=1)
    p.add_argument("--control", action="store_true")
    args = p.parse_args()
    harness.require_cards(1)
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(cell, seed, args.calls, args.control)
        for side, numbers in r.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side, **numbers,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
