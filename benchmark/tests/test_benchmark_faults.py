"""A run of each cell with the timed path broken underneath must come out
not correct. These drive the harness past its look for a card, on the CPU
at a small size (`tiny_cells.py`), with a fault planted in the port's
`InferenceEngine._predict`: half of each batch left out (its outputs the
other half's), or an answer altered where it is produced (a 4 x 4 patch of
every prediction). A sound run of the same size comes out correct."""

from __future__ import annotations

import pytest
import torch
from xmm_superres_denoise_torch.infer.run_file import InferenceEngine

from benchmark import harness

from .tiny_cells import tiny

SEED = 2**33 + 11


def _half_batch(predict):
    def broken(self, rep, x):
        h = max(1, x.shape[0] // 2)
        y = predict(self, rep, x[:h])
        return torch.cat([y, y[: x.shape[0] - h]])
    return broken


def _altered(predict):
    def broken(self, rep, x):
        y = predict(self, rep, x).clone()
        y[:, :4, :4] = 0.5
        return y
    return broken


def _run(cell):
    return harness.execute(cell, SEED, 0.2, False, device="cpu", log=lambda *a, **k: None)


@pytest.mark.parametrize("name", ["sr_bf16_bulk", "swinir_bf16_bulk"])
def test_sound_run_is_correct(name):
    r = _run(tiny(name))
    assert r["correct"], r["check"]


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
@pytest.mark.parametrize("name", ["sr_bf16_bulk", "swinir_bf16_bulk"])
def test_fault_is_not_correct(name, fault, monkeypatch):
    plant = {"half_batch": _half_batch, "altered_answer": _altered}[fault]
    monkeypatch.setattr(InferenceEngine, "_predict", plant(InferenceEngine._predict))
    r = _run(tiny(name))
    assert not r["correct"], r["check"]
