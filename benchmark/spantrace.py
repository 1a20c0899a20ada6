"""The traced window's device and idle time filed under the port's own spans.

`devtrace.reduce` sorts the device's busy time by kernel name and names an
idle gap by the innermost host event over its middle. `reduce` here files
both under the program's spans (`utils/profiling.py: annotate`):

    {"device_s": {span: s}, "idle_s": {span: s}}

- **Device time.** Each device operation (kernel, copy, set), clipped to
  the window, goes to the innermost `engine.*` or `zoo.*` span that holds
  the CUDA API call that launched it (`cudaLaunchKernel`,
  `cuLaunchKernelEx`, `cudaMemcpyAsync`, ...: the host event whose
  correlation id is the operation's own), even where it runs after that
  span has closed on the host. An operation whose call is not in the
  trace, or was made outside every such span, goes to the innermost span
  whose GPU mirror holds it, else to `unattributed`. Where operations
  overlap, each piece of their union is shared equally among them: the
  values are self times and sum to `busy_s`.
- **Idle time.** Each idle interval is split at the edges of the
  `engine.*`, `zoo.*` and `bench.*` spans over it, and each part goes to
  the innermost of them: the parts sum to `window_s - busy_s`.

Spans are taken to nest, as the one host thread that serves opens them.

    python3 -m benchmark.spantrace --workload <cell> --seed <n> --seconds <s> --trace 1

runs `harness.main` with the same arguments and, after its result line,
writes this reduction of the traced window to standard error as one
`[spans]` line: device and idle ms an image under each span, with their
sums against `busy_s` and `window_s - busy_s`.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from .devtrace import _union

T_START = time.perf_counter()  # set-up is timed from here, as in run.py

HOST, DEVICE, MIRROR = "host", "device", "mirror"
OWN = ("engine.", "zoo.")  # the spans device time is filed under
IDLE = OWN + ("bench.",)  # and those idle time is filed under
UNATTRIBUTED = "unattributed"
WINDOW = "bench.trace_window"

Span = Tuple[str, float, float]


def events_of(prof) -> list:
    """(name, kind, start_us, end_us, correlation id) of a finished
    torch.profiler run; kind is `HOST`, `DEVICE` (a kernel, copy or set)
    or `MIRROR` (the GPU-timeline side of a host span, a user annotation).
    A device operation and the CUDA API call that launched it
    share their correlation id (`FunctionEvent.id`)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            kind = HOST
        elif getattr(e, "is_user_annotation", False) or e.name.startswith("bench."):
            kind = MIRROR
        else:
            kind = DEVICE
        out.append((e.name, kind, e.time_range.start, e.time_range.end, e.id))
    return out


def _innermost(spans: Sequence[Span], points: Sequence[float]) -> List[Optional[str]]:
    """The name of the innermost of `spans` (nesting) that holds each of
    `points`, or None: one sweep in time order."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    out: List[Optional[str]] = [None] * len(points)
    stack: List[Span] = []
    i = 0
    for q in sorted(range(len(points)), key=points.__getitem__):
        t = points[q]
        while i < len(spans) and spans[i][1] <= t:
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[q] = stack[-1][0] if stack else None
    return out


def _self_times(ops: Sequence[Tuple[str, float, float]]) -> Tuple[Dict[str, float], float]:
    """Each key's share of the union of the (key, start, end) intervals,
    a piece covered by n of them counting 1/n to each; and the union's
    length."""
    edges = sorted([(a, 1, k) for k, a, b in ops] + [(b, -1, k) for k, a, b in ops],
                   key=lambda e: (e[0], e[1]))
    out: Dict[str, float] = defaultdict(float)
    active: Dict[str, int] = defaultdict(int)
    n, prev, union = 0, 0.0, 0.0
    for t, d, k in edges:
        if n and t > prev:
            union += t - prev
            for key, c in active.items():
                out[key] += (t - prev) * c / n
        active[k] += d
        if not active[k]:
            del active[k]
        n += d
        prev = t
    return dict(out), union


def _gaps(busy_edges: Sequence[Tuple[float, float]], w0: float, w1: float):
    """The complement of sorted, disjoint busy intervals inside [w0, w1]."""
    out, t = [], w0
    for a, b in busy_edges:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < w1:
        out.append((t, w1))
    return out


def file_events(events, window_span: str = WINDOW) -> dict:
    """`reduce` of `events_of`'s tuples."""
    windows = [(a, b) for n, k, a, b, _ in events if k == HOST and n == window_span]
    if not windows:
        raise RuntimeError(f"the trace holds no span {window_span!r}")
    w0, w1 = windows[0]
    idle_spans = [(n, a, b) for n, k, a, b, _ in events
                  if k == HOST and (n.startswith(IDLE) or n == window_span)]
    own = [s for s in idle_spans if s[0].startswith(OWN)]
    mirrors = [(n, a, b) for n, k, a, b, _ in events if k == MIRROR and n.startswith(OWN)]
    # CUDA API calls (cuda*, cu*) by correlation id: when each began
    calls = {corr: a for n, k, a, _, corr in events if k == HOST and n.startswith("cu")}
    ops = [(max(a, w0), min(b, w1), calls.get(corr)) for n, k, a, b, corr in events
           if k == DEVICE and b > w0 and a < w1]

    launched = [i for i, op in enumerate(ops) if op[2] is not None]
    keys: List[Optional[str]] = [None] * len(ops)
    for i, key in zip(launched, _innermost(own, [ops[i][2] for i in launched])):
        keys[i] = key
    rest = [i for i, k in enumerate(keys) if k is None]
    for i, key in zip(rest, _innermost(mirrors, [0.5 * (ops[i][0] + ops[i][1]) for i in rest])):
        keys[i] = key or UNATTRIBUTED
    device, busy = _self_times([(k, a, b) for k, (a, b, _) in zip(keys, ops)])

    # idle: the gaps between busy intervals, split at span edges
    edges = sorted({t for _, a, b in idle_spans for t in (a, b) if w0 < t < w1})
    parts = []
    for a, b in _gaps(_union([(a, b) for a, b, _ in ops]), w0, w1):
        cut = [a] + edges[bisect.bisect_right(edges, a):bisect.bisect_left(edges, b)] + [b]
        parts += [(p, q) for p, q in zip(cut, cut[1:]) if q > p]
    idle: Dict[str, float] = defaultdict(float)
    for (p, q), key in zip(parts, _innermost(idle_spans, [0.5 * (p + q) for p, q in parts])):
        idle[key] += q - p
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6,
            "device_s": {k: v * 1e-6 for k, v in device.items()},
            "idle_s": {k: v * 1e-6 for k, v in idle.items()}}


def reduce(prof, window_span: str = WINDOW) -> dict:
    """`{"device_s": {span: s}, "idle_s": {span: s}}` of a finished
    torch.profiler run over the host span `window_span` (module docstring),
    with the window's `window_s` and `busy_s` beside them."""
    return file_events(events_of(prof), window_span)


def line(red: dict, images: int) -> str:
    """The `[spans]` log line: device and idle ms an image under each span,
    largest first, and the sums against `busy_s` and `window_s - busy_s`."""
    def part(d):
        return ", ".join(f"{k} {1e3 * v / images:.4f}"
                         for k, v in sorted(d.items(), key=lambda kv: -kv[1]))

    dev, idle = sum(red["device_s"].values()), sum(red["idle_s"].values())
    idle_want = red["window_s"] - red["busy_s"]
    return (f"[spans] {images} images; device ms an image: {part(red['device_s'])}; "
            f"idle ms an image: {part(red['idle_s'])}; device sum / busy_s "
            f"{dev / red['busy_s'] if red['busy_s'] else float('nan'):.9f}, idle sum / "
            f"(window_s - busy_s) {idle / idle_want if idle_want else float('nan'):.9f}")


def main(argv, t_start: float) -> int:
    """`harness.main(argv)`, then the `[spans]` line of each traced window."""
    from . import devtrace, harness

    args = harness.parse_args(argv)
    mix = harness.load_cell(args.workload)["mix"]
    profs = []
    events_of_trace = devtrace.events_of

    def keep(prof):
        profs.append(prof)
        return events_of_trace(prof)

    devtrace.events_of = keep  # the harness's traced window hands its profiler here
    try:
        rc = harness.main(argv, t_start)
    finally:
        devtrace.events_of = events_of_trace
    for prof in profs:
        print(line(reduce(prof), mix["trace_calls"] * mix["call_images"]), file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
