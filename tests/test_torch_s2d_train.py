"""The S2D training route on the CPU: K1's gradient route and
`make_s2d_train_apply` against the JAX package's, and `memory_efficient`.

* `_DenseBlockS2DFn` (through `dense_block_s2d_train`; on the CPU its
  forward is K1's plain version) against autograd through the plain S2D
  block with the weights moved by the differentiable `s2d_conv_weights_torch`:
  the output bitwise, the gradients of the S2D input and of the ten
  original-domain parameters to 1e-5 x max|g| in f32 (the backward
  recomputes in the original domain, which sums in another order); in bf16
  (recomputed in the S2D domain with bf16 convolutions) both against the
  f32 gradient, the route within 1.5 x the error of the plain block's bf16
  autograd (bf16 gradients of this block are ~1e-1 x max|g| from f32 either
  way).
* `make_s2d_train_apply` for esr_gen SR (32^2 -> 64^2) and rrdb_denoise
  (32^2), 8 filters, 1 RRDB, from the Flax init, with and without `remat`:
  the loss (l1 0.3 + psnr 0.4 + ssim 0.3, sqrt table) to 1e-6 relative and
  the 40 (SR) or 36 (DN) gradients to 1e-5 x max|g| of each leaf against
  `jax.value_and_grad` of JAX's `make_s2d_train_apply`, and to the same
  bounds against the port's own model route.
* The S2D route at esr_gen's full width (32 filters, 4 RRDBs, as the
  shipped run configs train on it): `model(x, s2d=True)` against `model(x)`
  in f32, 2 x 32^2, the trained checkpoint for SR and seeded torch-default
  inits for DN, to 1e-5 on the [0, 1] output scale (f32 sums of up to
  5,760 products taken in another order).
* `memory_efficient` (each RRDB checkpointed) gives gradients bitwise equal
  to the plain model's.
"""

import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)
from _torch_train_common import LOSS_WEIGHTS, SQRT_TABLE, batch, state_dict_of

from xmm_superres_denoise_torch.config.schema import LossCfg as TLossCfg
from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_DN, GeneratorRRDB_SR
from xmm_superres_denoise_torch.ops.dense_block_s2d import (
    _DenseBlockS2DFn,
    dense_block_s2d_reference,
    dense_block_s2d_train,
)
from xmm_superres_denoise_torch.ops.s2d_forward import make_s2d_train_apply
from xmm_superres_denoise_torch.ops.space_to_depth import s2d_conv_weights_torch
from xmm_superres_denoise_torch.train import loss as tl
from xmm_superres_denoise_torch.utils.weights import params_from_flax

jrrdb = importlib.import_module("xmm_superres_denoise_tpu.models.rrdb")
js2d = importlib.import_module("xmm_superres_denoise_tpu.ops.s2d_forward")
jl = importlib.import_module("xmm_superres_denoise_tpu.train.loss")
jcfg = importlib.import_module("xmm_superres_denoise_tpu.config.schema")

PARAMS = Path(__file__).resolve().parents[1] / "docs/convergence_esr_gen/best_params.npz"
GRAD_RTOL, LOSS_RTOL = 1e-5, 1e-6
FULL_WIDTH_ATOL = 1e-5  # on the [0, 1] output scale
BF16_FACTOR = 1.5  # bf16 gradients: no worse than 1.5 x the plain bf16 autograd's error


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dense_block_s2d_fn_gradients_equal_autograd_of_the_plain_s2d_block(dtype):
    g = np.random.default_rng(0)
    c = 4
    x4 = torch.from_numpy(g.normal(size=(2, 12, 14, 4 * c)).astype(np.float32)).to(dtype)
    raw = []
    for k in range(1, 6):
        raw.append(torch.from_numpy((0.2 * g.normal(size=(3, 3, k * c, c))).astype(np.float32)))
        raw.append(torch.from_numpy((0.1 * g.normal(size=(c,))).astype(np.float32)))
    raw = [t.to(dtype) for t in raw]
    cot = torch.from_numpy(g.normal(size=x4.shape).astype(np.float32))

    def run(fn):
        xs = x4.clone().requires_grad_()
        ws = [t.clone().requires_grad_() for t in raw]
        y = fn(xs, *ws)
        (y.float() * cot).sum().backward()
        return y.detach(), [xs.grad] + [w.grad for w in ws]

    def plain(xs, *ws):
        pairs = [s2d_conv_weights_torch(ws[i], ws[i + 1]) for i in range(0, 10, 2)]
        return dense_block_s2d_reference(xs, [w for w, _ in pairs], [b for _, b in pairs])

    y1, g1 = run(dense_block_s2d_train)
    y2, g2 = run(plain)
    assert torch.equal(y1, y2) and all(t.dtype == dtype for t in g1)
    if dtype == torch.float32:
        errs = [_rel(a, b) for a, b in zip(g1, g2)]
        print(f"_DenseBlockS2DFn f32 vs autograd of the plain S2D block: gradients (x4, w1, "
              f"b1, ..., b5) largest max|diff|/max|g| {max(errs):.2e} (tol {GRAD_RTOL:.0e})")
        assert max(errs) <= GRAD_RTOL
        return
    # bf16: both against the f32 gradient of the same inputs
    x4, raw = x4.float(), [t.float() for t in raw]
    _, ref = run(plain)
    route = max(_rel(a.float(), b) for a, b in zip(g1, ref))
    base = max(_rel(a.float(), b) for a, b in zip(g2, ref))
    print(f"_DenseBlockS2DFn bf16: largest max|g - g_f32|/max|g_f32| {route:.2e}, the plain S2D "
          f"block's bf16 autograd {base:.2e} (tol {BF16_FACTOR} x it)")
    assert route <= BF16_FACTOR * base
    # only what requires grad gets a gradient; the shape check
    xs = x4.clone().requires_grad_()
    _DenseBlockS2DFn.apply(xs, *raw).sum().backward()
    assert xs.grad is not None and all(t.grad is None for t in raw)
    with pytest.raises(ValueError, match="S2D form"):
        dense_block_s2d_train(x4[..., :c], *raw)


@pytest.fixture(scope="module")
def losses():
    return (jl.create_loss(SQRT_TABLE, jcfg.LossCfg(**LOSS_WEIGHTS)),
            tl.create_loss(SQRT_TABLE, TLossCfg(**LOSS_WEIGHTS)))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("kind", ["sr", "dn"])
def test_s2d_train_apply_matches_jax_and_the_model_route(losses, kind, remat):
    jloss, tloss = losses
    jcls, tcls = ((jrrdb.GeneratorRRDB_SR, GeneratorRRDB_SR) if kind == "sr"
                  else (jrrdb.GeneratorRRDB_DN, GeneratorRRDB_DN))
    jmodel = jcls(num_filters=8, num_res_blocks=1)
    b = batch(seed=1, b=2, scale=2 if kind == "sr" else 1)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(b["lr"][:1]))
    japply = js2d.make_s2d_train_apply(jmodel, remat=remat)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(japply(p, jnp.asarray(b["lr"])), jnp.asarray(b["hr"]))))(params)
    ref = state_dict_of(jg)

    model = tcls(num_filters=8, num_res_blocks=1)
    model.load_state_dict(state_dict_of(params))
    x, hr = torch.from_numpy(b["lr"]), torch.from_numpy(b["hr"])
    apply = make_s2d_train_apply(model, remat=remat)
    v = tloss(apply(model, x), hr)
    v.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    v_model = tloss(torch.clamp(model(x), 0, 1), hr)
    v_model.backward()
    model_grads = {n: p.grad for n, p in model.named_parameters()}

    assert sorted(grads) == sorted(ref) and len(grads) == (40 if kind == "sr" else 36)
    vs_jax = max(_rel(grads[n], ref[n]) for n in ref)
    vs_model = max(_rel(grads[n], model_grads[n]) for n in ref)
    loss_err = abs(float(v) - float(jv)) / abs(float(jv))
    print(f"S2D train apply {kind}{' remat' if remat else ''}: loss {float(v):.8f} vs JAX "
          f"{float(jv):.8f} (rel {loss_err:.1e}, tol {LOSS_RTOL:.0e}) vs the model route "
          f"{float(v_model):.8f}; gradients largest max|diff|/max|g| vs JAX {vs_jax:.2e}, vs the "
          f"model route {vs_model:.2e} (tol {GRAD_RTOL:.0e})")
    assert loss_err <= LOSS_RTOL and abs(float(v) - float(v_model)) <= LOSS_RTOL * abs(float(v))
    assert vs_jax <= GRAD_RTOL and vs_model <= GRAD_RTOL


def test_s2d_train_apply_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="num_upsample"):
        make_s2d_train_apply(GeneratorRRDB_SR(num_filters=4, num_res_blocks=1, num_upsample=2))
    with pytest.raises(TypeError, match="RRDB generators"):
        make_s2d_train_apply(torch.nn.Linear(2, 2))


@pytest.mark.parametrize("sr", [True, False], ids=["sr", "dn"])
def test_full_width_forwards_match_the_model(sr):
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (2, 32, 32, 1)).astype(np.float32))
    model = GeneratorRRDB_SR() if sr else GeneratorRRDB_DN()
    if sr:
        model.load_state_dict(params_from_flax(PARAMS))
    else:
        model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.inference_mode():
        want = model(x)
        got = model(x, s2d=True)
    err = (got - want).abs().max().item()
    print(f"S2D route {'SR' if sr else 'DN'} at full width vs the model route: {err:.3e} "
          f"(tol {FULL_WIDTH_ATOL:.0e})")
    assert got.shape == want.shape
    assert err <= FULL_WIDTH_ATOL


@pytest.mark.parametrize("cls", [GeneratorRRDB_SR, GeneratorRRDB_DN])
def test_memory_efficient_gradients_are_bitwise_the_plain_ones(losses, cls):
    _, tloss = losses
    b = batch(seed=2, b=2, scale=2 if cls is GeneratorRRDB_SR else 1)
    x, hr = torch.from_numpy(b["lr"]), torch.from_numpy(b["hr"])
    grads = []
    for efficient in (False, True):
        model = cls(num_filters=8, num_res_blocks=2, memory_efficient=efficient)
        model.reset_parameters(torch.Generator().manual_seed(3))
        tloss(torch.clamp(model(x), 0, 1), hr).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    diff = max(float((grads[0][n] - grads[1][n]).abs().max()) for n in grads[0])
    print(f"memory_efficient {cls.__name__}: max|diff| of the {len(grads[0])} gradients {diff}")
    assert all(torch.equal(grads[0][n], grads[1][n]) for n in grads[0])
