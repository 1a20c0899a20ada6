"""Cells of this benchmark cut to a size a CPU test run holds: the
configurations' widths and depths, small images, small pools."""

from __future__ import annotations

from benchmark import harness

SIZES = {
    "sr_bf16_bulk": (dict(lr_res=32, hr_res=64, batch_size=2), [24, 22]),
    "swinir_bf16_bulk": (dict(lr_res=26, hr_res=52, batch_size=2), [24, 22]),
}


def tiny(name: str) -> dict:
    cell = harness.load_cell(name)
    cfg, hw = SIZES[name]
    cell["cfg"].update(cfg)
    cell["mix"].update(pool=6, call_images=4, native_hw=hw, source_margin=4)
    cell["check"].update(sample=4)
    return cell
