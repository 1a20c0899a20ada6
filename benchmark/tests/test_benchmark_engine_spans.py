"""The traced window's idle gaps as the port's `engine.*` spans name them.
`devtrace.reduce` names a gap by the innermost host event over its middle,
so a program span inside `bench.run_tiles` takes the gap from the
benchmark's own span; `devtrace.events_of` keeps the GPU-timeline mirror of
a span, which the profiler flags as a user annotation, out of the device
operations."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import devtrace

WINDOW = [("bench.trace_window", False, 0.0, 100.0), ("bench.run_tiles", False, 0.0, 100.0),
          ("K2", True, 5.0, 40.0), ("Memcpy DtoH (Device -> Pinned)", True, 45.0, 60.0)]
ENGINE = [("engine.call", False, 1.0, 99.0), ("engine.launch", False, 2.0, 10.0),
          ("engine.readback", False, 40.0, 61.0), ("engine.readback_wait", False, 41.0, 59.0),
          ("engine.gather", False, 62.0, 98.0)]


def test_engine_spans_name_the_idle_gaps_they_cover():
    gaps = dict(devtrace.reduce(WINDOW + ENGINE, "bench.trace_window")["idle_gaps"])
    assert gaps == pytest.approx({"engine.launch": 5e-6, "engine.readback_wait": 5e-6,
                                  "engine.gather": 40e-6})


def test_without_engine_spans_the_gaps_fall_to_the_benchmark_span():
    gaps = dict(devtrace.reduce(WINDOW, "bench.trace_window")["idle_gaps"])
    assert gaps == pytest.approx({"bench.run_tiles: host Python outside any torch operator": 50e-6})


def test_the_gpu_mirror_of_an_engine_span_is_no_device_operation():
    def event(name, device, annotation, start, end):
        return SimpleNamespace(name=name, is_user_annotation=annotation,
                               device_type=DeviceType.CUDA if device else DeviceType.CPU,
                               time_range=SimpleNamespace(start=start, end=end))

    prof = SimpleNamespace(events=lambda: [
        event("engine.gather", False, True, 0.0, 10.0),
        event("engine.gather", True, True, 0.0, 10.0),  # the mirror (gpu_user_annotation)
        event("K2", True, False, 2.0, 8.0),
    ])
    assert devtrace.events_of(prof) == [("engine.gather", False, 0.0, 10.0),
                                        ("K2", True, 2.0, 8.0)]
