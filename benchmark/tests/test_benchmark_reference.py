"""The frozen plain references held to the port's CPU model at small sizes
with the same weights: the references import nothing of the port; these
tests do, to show that both compute the configured pipeline."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.programs import rrdb as rrdb_program
from benchmark.programs import swinir as swinir_program
from benchmark.reference import rrdb, swinir

F32_TOL = 1e-5  # float32 on both sides; only the order of sums differs


def _rates(shape, seed):
    g = np.random.default_rng(seed)
    lam = np.full(shape, 1.5)
    lam[:, 8:13, 6:11] += 30.0
    return (g.poisson(lam) / 20000.0).astype(np.float32)


def _gap(a, b, scale):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()) / scale


def test_rrdb_reference_is_the_served_pipeline():
    cfg = dict(harness.load_cell("sr_bf16_bulk")["cfg"], lr_res=32, hr_res=64,
               dtype="float32", batch_size=2)
    engine = rrdb_program.build(cfg, 0, harness.ROOT, "cpu")
    raw = _rates((3, 30, 27), 1)
    pred, inp = engine.run_tiles(raw, batch_size=2)
    w = rrdb.weights(cfg, 0, harness.ROOT, "cpu")
    with torch.inference_mode():
        rp, ri = rrdb.serve(w, torch.from_numpy(raw), cfg)
    assert pred.shape == (3, 64, 64) and inp.shape == (3, 32, 32)
    assert pred.max() > 0.01 * cfg["hr_max"]  # the trained model says something
    assert _gap(pred, rp, cfg["hr_max"]) <= F32_TOL
    assert _gap(inp, ri, cfg["lr_max"]) <= F32_TOL


def test_rrdb_weights_are_held_to_their_digest():
    cfg = dict(harness.load_cell("sr_bf16_bulk")["cfg"], weights_sha256="0" * 64)
    with pytest.raises(RuntimeError, match="sha256"):
        rrdb.weights(cfg, 0, harness.ROOT, "cpu")


def test_swinir_reference_is_the_served_pipeline():
    """The served widths and 13 x 13 windows, unshifted, on a small image."""
    cfg = dict(harness.load_cell("swinir_bf16_bulk")["cfg"], dtype="float32", batch_size=2,
               lr_res=26, hr_res=52)
    raw = _rates((2, 24, 22), 2)
    params = swinir.make_params(cfg, 7, "cpu", torch.float32)
    engine = swinir_program.build(dict(cfg, dtype="bfloat16"), 7, harness.ROOT, "cpu")
    assert {k: tuple(v.shape) for k, v in engine.model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    from xmm_superres_denoise_torch.infer.run_file import InferenceEngine

    engine = InferenceEngine(swinir_program.model_config(cfg), swinir_program.dataset_config(cfg),
                             params, dtype=torch.float32, device="cpu")
    pred, inp = engine.run_tiles(raw, batch_size=2)
    with torch.inference_mode():
        rp, ri = swinir.serve(params, torch.from_numpy(raw), cfg)
    y = np.sqrt(pred / cfg["hr_max"])
    assert 0.05 < np.median(y) < 0.95  # the output lies inside the clip
    assert _gap(pred, rp, cfg["hr_max"]) <= F32_TOL
    assert _gap(inp, ri, cfg["lr_max"]) <= F32_TOL


@pytest.mark.parametrize("cut", [dict(img_size=16, patch_size=1, window_size=4),  # shifts
                                 dict(lr_res=30)])  # 30 is no multiple of 13
def test_swinir_reference_refuses_windows_it_does_not_carry(cut):
    cfg = dict(harness.load_cell("swinir_bf16_bulk")["cfg"], embed_dim=12, depths=[1],
               num_heads=[2], lr_res=16)
    cfg.update(cut)
    w = swinir.make_params(cfg, 1, "cpu", torch.float32)
    with pytest.raises(ValueError, match="unshifted"):
        swinir.model(w, torch.zeros(1, cfg["lr_res"], cfg["lr_res"], 1), cfg)


def test_seeded_swinir_weights_repeat_and_differ_by_seed():
    cfg = harness.load_cell("swinir_bf16_bulk")["cfg"]
    a, b = swinir.make_params(cfg, 2**33 + 1, "cpu"), swinir.make_params(cfg, 2**33 + 1, "cpu")
    c = swinir.make_params(cfg, 5, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_first.weight"], c["conv_first.weight"])
    assert all(v.dtype == torch.bfloat16 for v in a.values())
    assert (a["conv_last.bias"] == 0.5).all()


def test_float8_control_rounds_coarser_than_bfloat16():
    t = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    e8 = (swinir.fp8(t) - t).abs().max() / t.abs().max()
    e16 = (t.to(torch.bfloat16).float() - t).abs().max() / t.abs().max()
    assert e8 > 4 * e16
