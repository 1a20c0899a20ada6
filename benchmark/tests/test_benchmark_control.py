"""The control on the card at each cell's own size: on three seeds, the
program's readings pass every limit of the cell and the control's fail at
least one (`calibrate.readings` over enough calls of the cell's load to
compare as many outputs as a run does)."""

from __future__ import annotations

import pytest

from benchmark import calibrate, check, harness

SEEDS = (2**32 + 101, 2**32 + 202, 2**32 + 303)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sr_bf16_bulk", "swinir_bf16_bulk"])
def test_control_fails_and_program_passes_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own sizes on the port's kernels")
    cell = harness.load_cell(name)
    chk = cell["check"]
    limits = {k: chk[k] for k in check.NUMBERS if k in chk}
    calls = -(-chk["sample"] // chk["keep_per_call"])
    for seed in SEEDS:
        r = calibrate.readings(cell, seed, calls, control=True)
        print(name, seed, r)  # the readings, for the record of a run on the card
        assert all(r["program"][k] <= v for k, v in limits.items()), (seed, r)
        assert any(r["control"][k] > v for k, v in limits.items()), (seed, r)
