"""The DRCT cell through the harness on the CPU, cut to a size a CPU test
run holds (defined here, beside the cells of `tiny_cells.py`): embed 12 at
gc 32 (unequal heads, odd head sizes), two groups, window 8 with shift 4,
small images, a small pool. A sound run is correct; a run with either
fault of `test_benchmark_faults.py` planted in the port's
`InferenceEngine._predict` is not."""

from __future__ import annotations

import pytest
from xmm_superres_denoise_torch.infer.run_file import InferenceEngine

from benchmark import harness

from .test_benchmark_faults import SEED, _altered, _half_batch


def tiny_drct() -> dict:
    cell = harness.load_cell("drct_sr_bf16_bulk")
    cell["cfg"].update(embed_dim=12, depths=[5, 5], num_heads=[6, 6], window_size=8, img_size=32,
                       patch_size=2, lr_res=32, hr_res=64, batch_size=2)
    cell["mix"].update(pool=6, call_images=4, native_hw=[30, 28], source_margin=4)
    cell["check"].update(sample=4)
    return cell


def _run(cell):
    return harness.execute(cell, SEED, 0.2, False, device="cpu", log=lambda *a, **k: None)


def test_sound_drct_run_is_correct():
    r = _run(tiny_drct())
    assert r["correct"], r["check"]


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
def test_faulty_drct_run_is_not_correct(fault, monkeypatch):
    plant = {"half_batch": _half_batch, "altered_answer": _altered}[fault]
    monkeypatch.setattr(InferenceEngine, "_predict", plant(InferenceEngine._predict))
    r = _run(tiny_drct())
    assert not r["correct"], r["check"]
