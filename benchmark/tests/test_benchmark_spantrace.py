"""`spantrace`: the traced window's device and idle time filed under the
port's spans, on synthetic traces of (name, kind, start_us, end_us,
correlation id) events."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import devtrace, spantrace
from benchmark.spantrace import DEVICE, HOST, MIRROR

WINDOW = ("bench.trace_window", HOST, 0.0, 100.0, 1)


def _host(name, a, b, corr=0):
    return (name, HOST, a, b, corr)


def test_a_kernel_goes_to_the_span_that_launched_it_after_it_closed():
    """A cuBLAS kernel launched under `zoo.qkv` runs while the host is in
    `zoo.attention`; a kernel launched by `cuLaunchKernelEx` straight
    from `zoo.attention` (a ctypes launch, no torch op around it)."""
    events = [
        WINDOW, _host("engine.call", 1.0, 99.0, corr=2),
        _host("zoo.qkv", 10.0, 20.0, corr=3), _host("aten::mm", 11.0, 14.0, corr=4),
        _host("cudaLaunchKernel", 12.0, 13.0, corr=501),
        _host("zoo.attention", 20.0, 30.0, corr=5),
        _host("cuLaunchKernelEx", 21.0, 22.0, corr=502),
        ("gemm", DEVICE, 25.0, 40.0, 501),
        ("window_attention_sm90_kernel", DEVICE, 40.0, 55.0, 502),
    ]
    red = spantrace.file_events(events)
    assert red["device_s"] == pytest.approx({"zoo.qkv": 15e-6, "zoo.attention": 15e-6})


def test_without_a_launch_the_mirror_then_unattributed():
    events = [
        WINDOW, _host("engine.call", 1.0, 99.0, corr=2),
        ("zoo.mlp", MIRROR, 50.0, 70.0, 0), ("bench.run_tiles", MIRROR, 0.0, 100.0, 0),
        ("mlp_block_sm90_kernel", DEVICE, 55.0, 60.0, 601),  # no call, the mirror holds it
        ("Memcpy DtoH", DEVICE, 80.0, 85.0, 602),  # neither
        _host("cudaLaunchKernel", 0.5, 0.8, corr=603),  # launched outside every own span
        ("k", DEVICE, 86.0, 88.0, 603),
    ]
    red = spantrace.file_events(events)
    assert red["device_s"] == pytest.approx({"zoo.mlp": 5e-6, "unattributed": 7e-6})


def test_device_times_are_self_times_that_sum_to_busy_s():
    """Two kernels of two spans overlap for 10 us: each span takes half of
    the overlap; the window clips the last kernel."""
    events = [
        WINDOW, _host("zoo.proj", 5.0, 6.0), _host("zoo.mlp", 6.0, 7.0),
        _host("cudaLaunchKernel", 5.2, 5.3, corr=701),
        _host("cudaLaunchKernel", 6.2, 6.3, corr=702),
        _host("cudaLaunchKernel", 6.5, 6.6, corr=703),
        ("a", DEVICE, 10.0, 30.0, 701), ("b", DEVICE, 20.0, 35.0, 702),
        ("c", DEVICE, 90.0, 120.0, 703),
    ]
    red = spantrace.file_events(events)
    assert red["busy_s"] == pytest.approx(35e-6)
    assert red["device_s"] == pytest.approx({"zoo.proj": 15e-6, "zoo.mlp": 20e-6})
    assert sum(red["device_s"].values()) == pytest.approx(red["busy_s"], rel=1e-12)


def test_an_idle_gap_is_split_at_the_span_edges_it_crosses():
    """The gap 44-54 us runs from the last chunk's `engine.gather` through
    the end of one call and the start of the next into the next call's
    first `engine.upload`."""
    events = [
        WINDOW,
        _host("bench.run_tiles", 0.0, 50.0), _host("engine.call", 1.0, 48.0),
        _host("engine.readback", 39.0, 47.5), _host("engine.gather", 40.0, 47.0),
        _host("bench.run_tiles", 50.0, 100.0), _host("engine.call", 51.0, 99.0),
        _host("engine.launch", 51.5, 58.0), _host("engine.upload", 52.0, 56.0),
        ("k", DEVICE, 0.0, 44.0, 801), ("k", DEVICE, 54.0, 100.0, 802),
    ]
    red = spantrace.file_events(events)
    assert red["idle_s"] == pytest.approx({
        "engine.gather": 3e-6, "engine.readback": 0.5e-6, "engine.call": 1e-6,
        "bench.run_tiles": 3e-6, "engine.launch": 0.5e-6, "engine.upload": 2e-6})
    assert sum(red["idle_s"].values()) == pytest.approx(red["window_s"] - red["busy_s"])


def test_window_and_busy_are_devtraces_and_devtrace_is_unchanged():
    """On the engine trace `devtrace`'s tests read: the same window and busy
    time, and `devtrace` names the gaps by their middles as before."""
    trace = [("bench.trace_window", False, 0.0, 100.0), ("bench.run_tiles", False, 0.0, 100.0),
             ("K2", True, 5.0, 40.0), ("Memcpy DtoH (Device -> Pinned)", True, 45.0, 60.0),
             ("engine.call", False, 1.0, 99.0), ("engine.launch", False, 2.0, 10.0),
             ("engine.readback", False, 40.0, 61.0), ("engine.readback_wait", False, 41.0, 59.0),
             ("engine.gather", False, 62.0, 98.0)]
    old = devtrace.reduce(trace, "bench.trace_window")
    assert dict(old["idle_gaps"]) == pytest.approx({
        "engine.launch": 5e-6, "engine.readback_wait": 5e-6, "engine.gather": 40e-6})
    red = spantrace.file_events([(n, DEVICE if dev else HOST, a, b, 0)
                                 for n, dev, a, b in trace])
    assert (red["window_s"], red["busy_s"]) == pytest.approx((old["window_s"], old["busy_s"]))
    # split at the edges, where devtrace names each gap by its middle
    assert red["idle_s"] == pytest.approx({
        "bench.run_tiles": 2e-6, "engine.call": 3e-6, "engine.launch": 3e-6,
        "engine.readback": 2e-6, "engine.readback_wait": 4e-6, "engine.gather": 36e-6})
    assert red["device_s"] == pytest.approx({"unattributed": 50e-6})


def test_reduce_reads_the_profilers_events():
    def event(name, device, annotation, start, end, corr):
        return SimpleNamespace(name=name, is_user_annotation=annotation, id=corr,
                               device_type=DeviceType.CUDA if device else DeviceType.CPU,
                               time_range=SimpleNamespace(start=start, end=end))

    prof = SimpleNamespace(events=lambda: [
        event("bench.trace_window", False, True, 0.0, 10.0, 1),
        event("bench.trace_window", True, True, 0.0, 10.0, 0),  # mirrors
        event("engine.forward", False, True, 1.0, 3.0, 2),
        event("engine.forward", True, True, 2.0, 8.0, 0),
        event("cudaLaunchKernel", False, False, 1.5, 2.0, 900),
        event("K2", True, False, 2.0, 8.0, 900),
    ])
    assert spantrace.events_of(prof) == [
        ("bench.trace_window", HOST, 0.0, 10.0, 1), ("bench.trace_window", MIRROR, 0.0, 10.0, 0),
        ("engine.forward", HOST, 1.0, 3.0, 2), ("engine.forward", MIRROR, 2.0, 8.0, 0),
        ("cudaLaunchKernel", HOST, 1.5, 2.0, 900), ("K2", DEVICE, 2.0, 8.0, 900)]
    red = spantrace.reduce(prof, "bench.trace_window")
    assert red["device_s"] == pytest.approx({"engine.forward": 6e-6})
    assert red["idle_s"] == pytest.approx({"engine.forward": 1e-6, "bench.trace_window": 3e-6})
    line = spantrace.line(red, 2)
    assert line.startswith("[spans] 2 images; device ms an image: engine.forward 0.0030")
    assert "device sum / busy_s 1.000000000" in line
