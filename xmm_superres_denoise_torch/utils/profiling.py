"""Profiling and tracing instrumentation.

The port of the JAX package's `utils/profiling.py` on PyTorch's own tools:
`trace` captures a torch.profiler trace (host and, on a card, CUDA
activity) of a region, or of its first N steps, and writes it as a Chrome
trace (open it with chrome://tracing, Perfetto, or TensorBoard's profiler
plugin); `annotate` names a region in that trace (`record_function`);
`StepTimers` is a wall-clock timer registry for host pipeline stages;
`flops_estimate` counts a function's FLOPs with `FlopCounterMode`.
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional

import torch

log = logging.getLogger("xmmsr")


@contextlib.contextmanager
def trace(log_dir: Path, steps: Optional[int] = None) -> Iterator[Callable[[], None]]:
    """Capture a torch.profiler trace, written as
    `<log_dir>/<host>_<pid>.pt.trace.json`; yields `step`, to be called at
    the end of each step of the region.

    With `steps=None` the trace holds the whole region. With `steps=N` the
    N-th call of `step` stops the capture and writes the trace: the
    profiler keeps every event in host memory until then, so a long loop is
    traced over its first N steps only. Otherwise the trace is written on
    exit, also when the region raises."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = log_dir / f"{socket.gethostname()}_{os.getpid()}.pt.trace.json"
    prof = torch.profiler.profile(activities=activities)
    done = 0
    recording = True

    def finish() -> None:
        nonlocal recording
        if recording:
            recording = False
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(str(path))
            log.info("Profiler trace written to %s", path)

    def step() -> None:
        nonlocal done
        done += 1
        if done == steps:
            finish()

    prof.__enter__()
    try:
        yield step
    finally:
        finish()


def annotate(name: str):
    """Named region annotation visible in the trace."""
    return torch.profiler.record_function(name)


class StepTimers:
    """Accumulating wall-clock timers for host pipeline stages."""

    def __init__(self):
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._total[name] += time.perf_counter() - t0
            self._count[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self._total[name],
                "count": self._count[name],
                "mean_ms": 1e3 * self._total[name] / max(self._count[name], 1),
            }
            for name in self._total
        }

    def report(self) -> str:
        lines = [
            f"{name:30s} {s['count']:6d}x  {s['mean_ms']:8.2f} ms  {s['total_s']:8.2f} s"
            for name, s in sorted(self.summary().items())
        ]
        return "\n".join(lines)


def flops_estimate(fn, *args) -> Optional[float]:
    """FLOPs of one call `fn(*args)` as `torch.utils.flop_counter` counts
    them: 2 per multiply-add of matmuls and convolutions, elementwise work
    not counted (the JAX package's figure is XLA's cost analysis, by XLA's
    own rules). None when the call fails."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            fn(*args)
        return float(counter.get_total_flops())
    except Exception:
        return None
