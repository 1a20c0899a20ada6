"""Traffic kind `bulk`: archive reprocessing by one client in a closed
loop, each call `InferenceEngine.run_tiles` on the next `call_images`
images of a seeded pool, as `serve_files` hands the engine its sub-batches.

The pool follows `chip_smoke.py: _write_inputs` (detxy counts of a flat
Poisson background with point sources, over the exposure), drawn on the
device from the seed in a few bulk calls. A mix file of this kind
(`traffic/<mix>.toml`) holds:

    kind = "bulk"
    pool, call_images            images in the pool, images per call
    native_hw = [H, W]           detxy image size (numpy order)
    exposure_s                   counts -> rates
    background = [lo, hi]        counts per pixel, uniform per image
    sources, source_margin       point sources per image, kept off the edges
    source_counts = [lo, hi]     counts added to each pixel of a 5 x 5 box
    trace_calls                  whole calls in the profiled window
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

BOX = 5


def make_pool(mix: dict, seed: int, device) -> np.ndarray:
    """(pool, H, W) float32 rates on the host, the same for the same seed."""
    n, (h, w), s = mix["pool"], mix["native_hw"], mix["sources"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    lo, hi = mix["background"]
    bg = lo + (hi - lo) * torch.rand(n, generator=g, device=device, dtype=torch.float64)
    lam = bg[:, None, None].expand(n, h, w).contiguous()
    m = mix["source_margin"]
    ys = torch.randint(m, h - m, (n, s), generator=g, device=device)
    xs = torch.randint(m, w - m, (n, s), generator=g, device=device)
    lo, hi = mix["source_counts"]
    amp = lo + (hi - lo) * torch.rand(n, s, generator=g, device=device, dtype=torch.float64)
    off = torch.arange(BOX, device=device) - BOX // 2
    img = torch.arange(n, device=device)[:, None, None].expand(n, BOX, BOX)
    for k in range(s):  # one box per image per step: no index repeats within a step
        yy = (ys[:, k, None, None] + off[None, :, None]).expand(n, BOX, BOX)
        xx = (xs[:, k, None, None] + off[None, None, :]).expand(n, BOX, BOX)
        vals = amp[:, k, None, None].expand(n, BOX, BOX)
        lam.index_put_((img.reshape(-1), yy.reshape(-1), xx.reshape(-1)), vals.reshape(-1),
                       accumulate=True)
    counts = torch.poisson(lam, generator=g)
    return (counts.float() / mix["exposure_s"]).cpu().numpy()


def call_slice(mix: dict, i: int) -> np.ndarray:
    """Pool indices of call `i`: the next `call_images`, wrapping."""
    k = mix["call_images"]
    return (np.arange(k) + i * k) % mix["pool"]


def call_stack(pool: np.ndarray, mix: dict, i: int) -> np.ndarray:
    """The images of call `i`: a view of the pool where they do not wrap."""
    idx = call_slice(mix, i)
    return pool[idx[0] : idx[0] + len(idx)] if idx[-1] > idx[0] else pool[idx]


def run_window(serve: Callable, pool: np.ndarray, mix: dict, seconds: float, keep: int,
               rng: np.random.Generator, max_calls: Optional[int] = None) -> dict:
    """Calls until one ends at or after `seconds` from the first call's
    start (or `max_calls` calls). Keeps `keep` seeded images of each call's
    outputs (pool index, prediction, input half) for the comparison after
    the window. A call that raises counts its images as failed."""
    calls: List[tuple] = []
    kept: List[tuple] = []
    failed = 0
    t0 = time.perf_counter()
    i = 0
    while True:
        idx, stack = call_slice(mix, i), call_stack(pool, mix, i)
        ts = time.perf_counter()
        try:
            pred, inp = serve(stack)
        except RuntimeError as e:  # a failed call: its images are failed, the loop goes on
            print(f"[bulk] call {i} failed: {type(e).__name__}: {e}", flush=True)
            failed += len(idx)
            pred = inp = None
        te = time.perf_counter()
        if pred is not None:
            for p in rng.choice(len(idx), keep, replace=False):
                kept.append((int(idx[p]), pred[p].copy(), inp[p].copy()))
            del pred, inp  # the call's whole output goes before the next call
        calls.append((ts - t0, te - t0, len(idx)))
        i += 1
        if te - t0 >= seconds or i == max_calls:
            break
    window_s = calls[-1][1]
    attempted = sum(c[2] for c in calls)
    return {"calls": calls, "kept": kept, "attempted": attempted, "failed": failed,
            "window_s": window_s,
            "metrics": {"images_per_s": {"value": (attempted - failed) / window_s,
                                         "unit": "images/s"}}}


def traced_window(serve: Callable, pool: np.ndarray, mix: dict, first_call: int,
                  span: Callable) -> float:
    """`trace_calls` whole calls back to back, each inside a `span`;
    returns the host seconds they took."""
    t0 = time.perf_counter()
    for i in range(first_call, first_call + mix["trace_calls"]):
        with span("bench.run_tiles"):
            serve(call_stack(pool, mix, i))
    return time.perf_counter() - t0
