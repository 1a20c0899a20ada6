"""Profiling and tracing instrumentation.

The port of the JAX package's `utils/profiling.py` on PyTorch's own tools:
`trace` captures a torch.profiler trace (host and, on a card, CUDA
activity) of a region, or of its first N steps, and writes it as a Chrome
trace (open it with chrome://tracing, Perfetto, or TensorBoard's profiler
plugin); `annotate` names a region in that trace (`record_function`) while
a profiler records, and costs one flag read otherwise;
`flops_estimate` counts a function's FLOPs with `FlopCounterMode`.
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
from pathlib import Path
from typing import Callable, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

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


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A span named `name` in the trace of the profiler that is recording,
    as `record_function`; a no-op context when no profiler records. A
    `record_function` entered with the profiler off still costs about
    10 us; the flag read here costs a fraction of one. The flag is the
    process's, which torch's profiler sets in whichever thread it starts:
    torch's own thread-local check reads false in other threads, and in
    every thread under `profile_all_threads`."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


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
