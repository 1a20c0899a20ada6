"""Reduction of a torch.profiler trace of a steady window to what the
per-layer metrics read: the device operations (kernels, copies, sets)
inside the window, the device's busy time (the union of their intervals),
and the idle gaps, each named by the innermost host event that covers
its middle (a Python function, an operator, a CUDA runtime call, or a
`bench.*` span).

`window_span` is the name of the host span that marks the window.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

TOP = 10  # entries of each breakdown list


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(events, window_span: str) -> dict:
    """`events`: (name, is_device, start_us, end_us) of every traced event."""
    spans = [(a, b) for n, dev, a, b in events if not dev and n == window_span]
    if not spans:
        raise RuntimeError(f"the trace holds no span {window_span!r}")
    w0, w1 = spans[0]
    ops = [(n, max(a, w0), min(b, w1)) for n, dev, a, b in events
           if dev and b > w0 and a < w1]
    busy = _union([(a, b) for _, a, b in ops])
    by_name: Dict[str, float] = defaultdict(float)
    for n, a, b in ops:
        by_name[n] += (b - a) * 1e-6
    host = [(n, a, b) for n, dev, a, b in events if not dev and n != window_span]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        cover = [(e - s, n) for n, s, e in host if s <= mid <= e]
        name = min(cover)[1] if cover else "host outside any traced event"
        if name.startswith("bench."):  # no operator or runtime call inside the span
            name += ": host Python outside any torch operator"
        gaps[name] += (b - a) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "ops": [(n, a * 1e-6, b * 1e-6) for n, a, b in ops],
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP],
    }


def events_of(prof) -> list:
    """(name, is_device, start_us, end_us) of a finished torch.profiler run.
    The device side of a host span (a user annotation the profiler mirrors
    onto the GPU timeline) is no device operation and is left out."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        dev = e.device_type == DeviceType.CUDA
        if dev and (getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")):
            continue
        out.append((e.name, dev, e.time_range.start, e.time_range.end))
    return out
