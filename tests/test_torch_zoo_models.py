"""The transformer zoo's whole models against the JAX package's, on the CPU.

Tiny configurations, as the JAX package's `tests/test_transformer_zoo.py`
builds them (embed 12, depths (2,) or (2, 2), 24^2 inputs; HAT with
squeeze factor 4 and overlap 1/3, and through the registry at embed 60;
Restormer at dim 8 on 32^2): SwinIR with each of its four heads (the SR
pixelshuffle head, the denoise head with shifted windows, nearest+conv on
an input that needs the reflect pad, pixelshuffledirect), SwinFIR, DRCT,
HAT and Restormer. Weights come from JAX's init, carried across through
`utils/weights.py`; inputs from a numpy seed. Per model:

* f32: max|port - JAX| <= 1e-5 x max(1, max|JAX|);
* bf16: within 4 bf16 ulps x max(1, max|JAX f32|) of JAX's bf16;
* the port's state_dict written back to the Flax layout equals JAX's
  parameters bitwise, key for key.

`scan_layers` (DRCT, and HAT with two groups): JAX's `stack_layer_params`
tree, saved by JAX's `save_params_npz`, loads into the port's scan-built
model through `load_params_npz`, whose forward matches JAX's scanned model
at the f32 class, and the port's `save_params_npz` writes the same npz
bitwise.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)
from _torch_zoo_common import (
    BF16_TOL,
    F32_TOL,
    check,
    jax_apply,
    jax_init,
    jzoo,
    port,
    run_port,
    x_np,
)

from xmm_superres_denoise_torch import config as tcfg
from xmm_superres_denoise_torch.models import drct as tdrct
from xmm_superres_denoise_torch.models import hat as thaat
from xmm_superres_denoise_torch.models import restormer as trest
from xmm_superres_denoise_torch.models import swinir as tswinir
from xmm_superres_denoise_torch.models.registry import build_model
from xmm_superres_denoise_torch.utils.weights import (
    flax_tree,
    load_params_npz,
    params_from_flax,
    save_params_npz,
)

jcfg = importlib.import_module("xmm_superres_denoise_tpu.config")
jregistry = importlib.import_module("xmm_superres_denoise_tpu.models.registry")
jscan = importlib.import_module("xmm_superres_denoise_tpu.models.scan_stack")
jck = importlib.import_module("xmm_superres_denoise_tpu.train.checkpoints")

SWIN = dict(img_size=24, patch_size=8, in_chans=1, embed_dim=12, depths=(2, 2),
            num_heads=(2, 2), window_size=8, mlp_ratio=2.0, upscale=2,
            upsampler="pixelshuffle", num_feat=8)
SHIFTED_DN = dict(img_size=24, patch_size=1, in_chans=1, embed_dim=12, depths=(2,),
                  num_heads=(2,), window_size=6, mlp_ratio=2.0, upscale=1, upsampler="")
DRCT = dict(img_size=24, patch_size=8, in_chans=1, embed_dim=12, depths=(1, 1),
            num_heads=(2, 2), window_size=8, mlp_ratio=2.0, upscale=2, gc=6, num_feat=8)
HAT = dict(img_size=24, patch_size=1, in_chans=1, embed_dim=12, depths=(2,), num_heads=(2,),
           window_size=6, mlp_ratio=2.0, upscale=2, squeeze_factor=4, num_feat=8,
           overlap_ratio=1 / 3)
RESTORMER = dict(inp_channels=1, out_channels=1, dim=8, num_blocks=(1, 1, 1, 1),
                 num_refinement_blocks=1, heads=(1, 2, 4, 8))


def _registry_hat():
    """HAT through both registries at embed 60 (its channel attention
    squeezes by 30), as the JAX package's registry test builds it."""
    def cfg(mod):
        kw = dict(name="hat", memory_efficient=False, batch_size=1,
                  optimizer=mod.OptimizerCfg(learning_rate=2e-4))
        section = dict(base_model="hat", img_size=24, window_size=8, patch_size=8,
                       embed_dim=60, upsampler="pixelshuffle", in_channels=1,
                       num_heads=[2], depths=[1])
        return mod.ModelCfg(model=mod.TransformerCfg(**section), **kw)

    return (jregistry.build_model(cfg(jcfg), (24, 24), (48, 48)),
            build_model(cfg(tcfg), (24, 24), (48, 48)))


CASES = {
    "swinir": lambda: (jzoo.SwinIR(**SWIN), tswinir.SwinIR(**SWIN), x_np(seed=0)),
    "swinir-dn-shifted": lambda: (jzoo.SwinIR(**SHIFTED_DN), tswinir.SwinIR(**SHIFTED_DN),
                                  x_np(seed=2)),
    "swinir-nearest-padded": lambda: (
        jzoo.SwinIR(**dict(SWIN, upsampler="nearest+conv", depths=(2,), num_heads=(2,))),
        tswinir.SwinIR(**dict(SWIN, upsampler="nearest+conv", depths=(2,), num_heads=(2,))),
        x_np(s=23, seed=8)),
    "swinir-direct": lambda: (
        jzoo.SwinIR(**dict(SWIN, upsampler="pixelshuffledirect", depths=(2,), num_heads=(2,))),
        tswinir.SwinIR(**dict(SWIN, upsampler="pixelshuffledirect", depths=(2,),
                              num_heads=(2,))),
        x_np(seed=9)),
    "swinfir": lambda: (jzoo.SwinFIR(**dict(SWIN, depths=(2,), num_heads=(2,))),
                        tswinir.SwinFIR(**dict(SWIN, depths=(2,), num_heads=(2,))),
                        x_np(seed=3)),
    "drct": lambda: (jzoo.DRCT(**DRCT), tdrct.DRCT(**DRCT), x_np(seed=4)),
    "hat": lambda: (jzoo.HAT(**HAT), thaat.HAT(**HAT), x_np(seed=5)),
    "hat-registry-60": lambda: (*_registry_hat(), x_np(seed=8)),
    "restormer": lambda: (jzoo.Restormer(**RESTORMER), trest.Restormer(**RESTORMER),
                          x_np(s=32, seed=7)),
}
OUT_SHAPE = {"swinir-dn-shifted": (1, 24, 24, 1), "swinir-nearest-padded": (1, 46, 46, 1),
             "restormer": (1, 32, 32, 1)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_model_matches_jax_in_f32_and_bf16(name, tmp_path):
    jm, tm, x = CASES[name]()
    want, v = jax_init(jm, x, with_output=True)
    tm = port(tm, v)
    # the state_dict back in the Flax layout is JAX's tree, bitwise
    back = _flat(flax_tree(tm.state_dict()))
    ref = _flat(v["params"])
    assert sorted(back) == sorted(ref)
    assert all(np.array_equal(back[k], ref[k]) for k in ref)
    assert want.shape == OUT_SHAPE.get(name, (1, 48, 48, 1))
    e32 = check(run_port(tm, x), want, F32_TOL, f"{name} f32")
    if name in SCAN_CASES:
        _scan_round_trip(name, v, x, want, tmp_path)
    want16 = jax_apply(jm, v, x, dtype=jnp.bfloat16)
    e16 = check(run_port(tm, x, dtype=torch.bfloat16), want16, BF16_TOL, f"{name} bf16",
                scale=want)
    print(f"{name}: {len(ref)} Flax arrays round-trip bitwise; f32 {e32:.2e}, bf16 {e16:.2e}")


SCAN_CASES = {  # JAX's and the port's constructors, each taking scan_layers
    "drct": (lambda **k: jzoo.DRCT(**DRCT, **k), lambda **k: tdrct.DRCT(**DRCT, **k)),
    "hat-scan": (lambda **k: jzoo.HAT(**dict(HAT, depths=(1, 1), num_heads=(2, 2)), **k),
                 lambda **k: thaat.HAT(**dict(HAT, depths=(1, 1), num_heads=(2, 2)), **k)),
}


def _scan_round_trip(name, v, x, want, tmp_path):
    """JAX's unrolled init stacked (`stack_layer_params`) and saved by JAX's
    `save_params_npz` -> the port's scan-built model through
    `load_params_npz`: its forward is JAX's scanned model's at the f32 class
    (and the unrolled `want`), and the port's `save_params_npz` writes the
    same npz bitwise."""
    jmake, tmake = SCAN_CASES[name]
    scanned = {"params": jscan.stack_layer_params(v["params"])}
    jck.save_params_npz(tmp_path / "jax.npz", scanned)
    jwant = jax_apply(jmake(scan_layers=True), scanned, x)
    model = tmake(scan_layers=True)
    flat = load_params_npz(tmp_path / "jax.npz", model)
    assert any(k.startswith("layers_scan/") for k in flat)
    assert not any(k.startswith("layers_0/") for k in flat)
    model.load_state_dict(params_from_flax(flat, model))
    got = run_port(model.eval(), x)
    check(got, jwant, F32_TOL, f"{name} scan_layers forward vs JAX's scanned model")
    check(got, want, F32_TOL, f"{name} scan_layers forward vs JAX's unrolled model")
    save_params_npz(tmp_path / "port.npz", model)
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
        n, stacked = len(a.files), a[next(k for k in a.files if "layers_scan" in k)].shape[0]
    print(f"{name} scan layout: {n} npz arrays, {stacked} groups stacked, bitwise round trip")


def test_hat_scan_layers_npz_round_trip(tmp_path):
    jmake, tmake = SCAN_CASES["hat-scan"]
    x = x_np(seed=11)
    want, v = jax_init(jmake(), x, with_output=True)
    _scan_round_trip("hat-scan", v, x, want, tmp_path)
