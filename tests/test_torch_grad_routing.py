"""Gradients through the dense block: the routing to `_DenseBlockFn`, its
backward, and the model's gradients against `jax.grad`, on the CPU.

* The routing decision (`grad_needed`): no grad mode, grad mode with
  nothing requiring grad, an input requiring grad, a weight requiring grad.
  On the card a needed gradient sends the block through `_DenseBlockFn` (K2
  forward, recomputed backward); otherwise K2 is launched straight.
* `_DenseBlockFn.apply` on CPU tensors (its forward then runs the plain
  version): the gradients of x and all ten parameters equal autograd
  through `dense_block_reference`, bitwise in f32.
* The trained esr_gen model's 130 parameter gradients through
  `train/loss.py` at (1, 32, 32, 1) -> 64^2 are within 1e-5 x max|g| of
  `jax.grad` of the JAX loss through the Flax model. The loss is the run
  config's psnr + ms_ssim with SSIM for MS-SSIM (which needs 208 px), plus
  L1 (its `where` form), with the sqrt scaling table. The Poisson NLL term
  is left out here: its gradient t / (p + 1e-8) at the 2 % of predictions
  below 1e-3 makes the f32 gradient itself ill-conditioned (measured on
  this input: the port's f32 gradients 1.5e-4 x max|g| from its float64
  ones with Poisson alone, 1e-6 without it); `test_torch_loss.py` holds the
  Poisson term's gradient against JAX's.
* The inference-only ops refuse a gradient: `dense_block_s2d`, `conv_i8`,
  `rrdb_fused` and the fast forward raise `RuntimeError` (on every device;
  the card tests repeat this on CUDA tensors).
"""

import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from xmm_superres_denoise_torch.config.schema import LossCfg as TLossCfg
from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_SR
from xmm_superres_denoise_torch.ops import conv_i8 as tk3
from xmm_superres_denoise_torch.ops import dense_block as tdb
from xmm_superres_denoise_torch.ops.dense_block_s2d import dense_block_s2d
from xmm_superres_denoise_torch.train import loss as tl
from xmm_superres_denoise_torch.utils.weights import params_from_flax

flax_rrdb = importlib.import_module("xmm_superres_denoise_tpu.models.rrdb")
jl = importlib.import_module("xmm_superres_denoise_tpu.train.loss")
jcfg = importlib.import_module("xmm_superres_denoise_tpu.config.schema")

ROOT = Path(__file__).resolve().parents[1]
PARAMS = ROOT / "docs/convergence_esr_gen/best_params.npz"
GRAD_RTOL = 1e-5
LOSS_WEIGHTS = dict(l1=0.3, poisson=0.0, psnr=0.4, ssim=0.3, ms_ssim=0.0)
SQRT_TABLE = {  # the sqrt rows of res/configs/loss_functions.toml's scaling tables
    name: row for name, row in __import__("tomllib").loads(
        (ROOT / "res/configs/loss_functions.toml").read_text())["scaling"]["sqrt"].items()
}


def _block(c=8, seed=0, shape=(1, 6, 7)):
    g = np.random.default_rng(seed)
    x = torch.from_numpy(g.normal(size=(*shape, c)).astype(np.float32))
    ws = []
    for j in range(1, 6):
        ws.append(torch.from_numpy((0.1 * g.normal(size=(3, 3, c * j, c))).astype(np.float32)))
        ws.append(torch.from_numpy((0.1 * g.normal(size=(c,))).astype(np.float32)))
    return x, ws


@pytest.mark.parametrize("case", ["no_grad", "grad_mode_nothing_requires", "input_requires",
                                  "weight_requires"])
def test_routing_decision(case):
    x, ws = _block()
    want = case in ("input_requires", "weight_requires")
    if case == "input_requires":
        x.requires_grad_()
    if case == "weight_requires":
        ws[7].requires_grad_()
    if case == "no_grad":
        x.requires_grad_()
        with torch.no_grad():
            assert not tdb.grad_needed(x, *ws)
        with torch.inference_mode():
            assert not tdb.grad_needed(x, *ws)
        return
    assert tdb.grad_needed(x, *ws) is want
    # on the CPU the plain version runs either way; a gradient flows exactly when needed
    y = tdb.dense_block(x, *ws)
    assert (y.grad_fn is not None) is want


def test_model_block_passes_raw_params_only_when_grad_is_needed(monkeypatch):
    from xmm_superres_denoise_torch.models import rrdb

    seen = []
    monkeypatch.setattr(rrdb, "dense_block", lambda x, *w: seen.append(len(w)) or x)
    block = rrdb.ResidualDenseBlock5C(8, 8)
    x = torch.zeros(1, 4, 4, 8)
    block(x)  # parameters require grad: the ten raw tensors
    with torch.no_grad():
        block(x)  # the cached pack
    with torch.inference_mode():
        block(x)
    block.requires_grad_(False)
    block(x)
    block(x.requires_grad_())
    assert seen == [10, 1, 1, 1, 10]


def test_dense_block_fn_gradients_equal_autograd_through_the_plain_version():
    x, ws = _block(c=8, seed=1)
    cot = torch.from_numpy(np.random.default_rng(2).normal(size=x.shape).astype(np.float32))

    def grads(fn):
        xs = x.clone().requires_grad_()
        wr = [w.clone().requires_grad_() for w in ws]
        y = fn(xs, *wr)
        (y * cot).sum().backward()
        return y.detach(), [xs.grad] + [w.grad for w in wr]

    y1, g1 = grads(tdb._DenseBlockFn.apply)
    y2, g2 = grads(tdb.dense_block_reference)
    assert torch.equal(y1, y2)
    diffs = [float((a - b).abs().max()) for a, b in zip(g1, g2)]
    print(f"_DenseBlockFn vs autograd of the plain version: max|diff| per input {diffs}")
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    # only what requires grad gets a gradient
    xs = x.clone().requires_grad_()
    y = tdb._DenseBlockFn.apply(xs, *ws)
    y.sum().backward()
    assert xs.grad is not None and all(w.grad is None for w in ws)


def test_model_gradients_match_jax_grad():
    with np.load(PARAMS) as npz:
        flat = {k: npz[k] for k in npz.files}
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)

    g = np.random.default_rng(3)
    x = g.uniform(0, 1, (1, 32, 32, 1)).astype(np.float32)
    coarse = g.uniform(0.05, 1, (1, 8, 8, 1))
    target = np.clip(np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)
                     + 0.05 * g.normal(size=(1, 64, 64, 1)), 0.01, 1).astype(np.float32)

    jloss = jl.create_loss(SQRT_TABLE, jcfg.LossCfg(**LOSS_WEIGHTS))
    jmodel = flax_rrdb.GeneratorRRDB_SR()

    def jax_loss(params):
        pred = jnp.clip(jmodel.apply(params, jnp.asarray(x)), 0.0, 1.0)
        return jloss(pred, jnp.asarray(target))

    jv, jg = jax.value_and_grad(jax_loss)(tree)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, jg))

    model = GeneratorRRDB_SR()
    model.load_state_dict(params_from_flax(flat))
    tloss = tl.create_loss(SQRT_TABLE, TLossCfg(**LOSS_WEIGHTS))
    v = tloss(torch.clamp(model(torch.from_numpy(x)), 0.0, 1.0), torch.from_numpy(target))
    v.backward()
    v = float(v.detach())
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert len(grads) == 130 and sorted(grads) == sorted(ref)
    worst, worst_name = 0.0, None
    for n, gr in grads.items():
        scale = float(ref[n].abs().max())
        err = float((gr - ref[n]).abs().max()) / max(scale, 1e-30)
        if err > worst:
            worst, worst_name = err, n
        assert gr is not None and torch.isfinite(gr).all()
        assert err <= GRAD_RTOL, (n, err)
    print(f"loss {v:.8f} vs JAX {float(jv):.8f}; 130 gradients, largest "
          f"max|g_port - g_jax| / max|g_jax| {worst:.3e} ({worst_name}; tol {GRAD_RTOL:.0e})")
    assert abs(v - float(jv)) <= 1e-5 * abs(float(jv))


def test_inference_only_ops_refuse_a_gradient():
    c = 128
    g = np.random.default_rng(4)
    x = torch.from_numpy(g.normal(size=(1, 16, 104, c)).astype(np.float32)).requires_grad_()
    ws = [torch.from_numpy((0.01 * g.normal(size=(3, 3, k * c, c))).astype(np.float32))
          for k in range(1, 6)]
    bs = [torch.zeros(c) for _ in range(5)]
    with pytest.raises(RuntimeError, match="inference only"):
        dense_block_s2d(x, ws, bs)
    with pytest.raises(RuntimeError, match="inference only"):
        dense_block_s2d(x, tdb.pack_weights(ws, bs, torch.float32))
    with torch.no_grad():
        assert dense_block_s2d(x, ws, bs).shape == x.shape

    x8 = torch.zeros((1, 4, 4, 32), dtype=torch.int8)
    w8 = torch.zeros((3, 3, 32, 128), dtype=torch.int8)
    ep = tk3.Epilogue(c_o=torch.ones(128), bias=torch.zeros(128), dtype=torch.float32,
                      res_scale=0.2)
    residual = torch.zeros((1, 4, 4, 128)).requires_grad_()
    with pytest.raises(RuntimeError, match="inference only"):
        tk3.conv_i8(x8, w8, ep, residual=residual)
    assert tk3.conv_i8(x8, w8, ep, residual=residual.detach()).shape == (1, 4, 4, 128)

    xs = torch.zeros((1, 8, 8, 32)).requires_grad_()
    pairs = [[(torch.zeros(3, 3, 32 * k, 32), torch.zeros(32)) for k in range(1, 6)]] * 3
    with pytest.raises(RuntimeError, match="inference only"):
        tdb.rrdb_fused(xs, pairs)
    with torch.no_grad():
        assert tdb.rrdb_fused(xs, pairs).shape == xs.shape

    model = GeneratorRRDB_SR(num_filters=8, num_res_blocks=1)
    fast = tdb.make_fast_rrdb_forward(model, model.state_dict(), torch.float32, "cpu")
    xf = torch.rand((1, 16, 16, 1)).requires_grad_()
    with pytest.raises(RuntimeError, match="inference only"):
        fast(xf)
    with torch.no_grad():
        assert fast(xf).shape == (1, 32, 32, 1)
