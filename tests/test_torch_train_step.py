"""The port's train steps against the JAX package's, on the CPU.

The esr_gen generator at 8 filters and 1 RRDB, 32^2 -> 64^2, from the Flax
init (`model.init(PRNGKey(0))`) converted with `params_from_flax`; the loss
is l1 0.3 + psnr 0.4 + ssim 0.3 with the run config's sqrt scaling table
(MS-SSIM, the run config's other term, needs 208 px). JAX's steps run on a
one-device CPU mesh. Tolerances, printed with what each test measured:

* one f32 step: the loss to 1e-6 relative; every gradient to 1e-5 x max|g|
  of its leaf (against `make_accum_steps`' grad_step); the parameters after
  3 Adam steps to 1e-3 x lr, leaving out the entries whose gradient has
  |g| < 1e-6 at one of the steps (Adam's first step is lr * g / (|g| +
  1e-8), which turns a rounding difference there into up to 2 lr, and a
  LeakyReLU kink moved by it changes the next steps' gradients; the test
  prints how many);
* accumulation (k = 2, the second micro-batch padded) against JAX's
  accumulation and against one batch of the real rows, the same bounds;
* `gradient_clip_val` against `optax.clip_by_global_norm`, below and above
  the threshold: the clipped gradients to 1e-6 relative, and a clipped
  step's parameters as above;
* a bf16 step (`compute_dtype=bfloat16`) against JAX's: the loss to 1e-3
  relative, the weight gradients to 3e-2 x max|g| of JAX's bf16 ones (bf16
  forwards of the two packages differ by a few bf16 ulps); the bias
  gradients to 3e-2 x max|g| of the f32 gradient, because JAX's bf16 bias
  gradients on the CPU are 0.2-0.6 x max|g| from it (XLA sums the
  cotangent over the pixels in bf16; the port sums in f32), which the test
  prints; the masters, the loss and the gradients stay f32.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)
from _torch_train_common import LOSS_WEIGHTS, SQRT_TABLE, batch, state_dict_of, to_torch

from xmm_superres_denoise_torch.config.schema import LossCfg as TLossCfg
from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_SR
from xmm_superres_denoise_torch.train import loss as tl
from xmm_superres_denoise_torch.train import steps as ts

jrrdb = importlib.import_module("xmm_superres_denoise_tpu.models.rrdb")
jl = importlib.import_module("xmm_superres_denoise_tpu.train.loss")
jcfg = importlib.import_module("xmm_superres_denoise_tpu.config.schema")
jsteps = importlib.import_module("xmm_superres_denoise_tpu.train.steps")
jmesh = importlib.import_module("xmm_superres_denoise_tpu.parallel.mesh")

LR = 1e-4  # esr_gen's learning rate (res/configs/models.toml)
LOSS_RTOL, GRAD_RTOL, PARAM_ATOL = 1e-6, 1e-5, 1e-3 * LR
TINY_G = 1e-6
BF16_RTOL = 3e-2
FILTERS, BLOCKS = 8, 1


@pytest.fixture(scope="module")
def setup():
    jmodel = jrrdb.GeneratorRRDB_SR(num_filters=FILTERS, num_res_blocks=BLOCKS)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    jloss = jl.create_loss(SQRT_TABLE, jcfg.LossCfg(**LOSS_WEIGHTS))
    tloss = tl.create_loss(SQRT_TABLE, TLossCfg(**LOSS_WEIGHTS))
    mesh = jmesh.make_mesh(data=1, fsdp=1)
    return dict(jmodel=jmodel, params=params, jloss=jloss, tloss=tloss, mesh=mesh,
                japply=lambda p, x: jnp.clip(jmodel.apply(p, x), 0.0, 1.0))


def _port_state(setup, tx):
    model = GeneratorRRDB_SR(num_filters=FILTERS, num_res_blocks=BLOCKS)
    model.load_state_dict(state_dict_of(setup["params"]))
    return ts.TrainState.create(model, tx)


def _jax_tx(clip=0.0):
    adam = optax.adam(LR, b1=0.9, b2=0.999)
    return optax.chain(optax.clip_by_global_norm(clip), adam) if clip > 0 else adam


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _grads_of(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def _compare_tree(port: dict, ref_flax, rtol, label, mask=None):
    """Largest max|port - ref| / max|ref| over the leaves (masked entries left out)."""
    ref = state_dict_of(ref_flax)
    assert sorted(port) == sorted(ref)
    worst, left_out = 0.0, 0
    for n, r in ref.items():
        d = (port[n] - r).abs()
        if mask is not None:
            left_out += int((~mask[n]).sum())
            d = d[mask[n]]
        err = float(d.max()) / max(float(r.abs().max()), 1e-30) if d.numel() else 0.0
        worst = max(worst, err)
        assert err <= rtol, (label, n, err)
    return worst, left_out


def _param_diff(model, jparams, mask):
    ref = state_dict_of(jparams)
    worst, left_out = 0.0, 0
    for n, p in model.named_parameters():
        d = (p.detach() - ref[n]).abs()[mask[n]]
        left_out += int((~mask[n]).sum())
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst, left_out


def test_f32_step_matches_jax_loss_gradients_and_three_adam_steps(setup):
    b = batch(seed=0, b=2)
    tx = ts.Tx(LR)
    jtx = _jax_tx()
    # gradients: JAX's accumulation grad_step divided once, the port's grad_step
    jgrad, _ = jsteps.make_accum_steps(setup["japply"], setup["jloss"], jtx, mesh=setup["mesh"],
                                       donate=False)
    gsum, jlsum, jwsum = jgrad(setup["params"], _jbatch(b))
    jg = jax.tree_util.tree_map(lambda g: g / jwsum, gsum)
    state = _port_state(setup, tx)
    grad_step, _ = ts.make_accum_steps(ts.clamped_apply, setup["tloss"], tx)
    lsum, wsum = grad_step(state, to_torch(b))
    grads = {n: g / wsum for n, g in _grads_of(state.module).items()}
    loss_err = abs(float(lsum / wsum) - float(jlsum / jwsum)) / abs(float(jlsum / jwsum))
    g_worst, _ = _compare_tree(grads, jg, GRAD_RTOL, "grad")

    # three steps of each package's train step
    jstep = jsteps.make_train_step(setup["japply"], setup["jloss"], jtx, setup["mesh"],
                                   donate=False)
    jstate = jsteps.TrainState.create(setup["params"], jtx)
    state = _port_state(setup, tx)
    step = ts.make_train_step(ts.clamped_apply, setup["tloss"], tx)
    mask = {n: g.abs() >= TINY_G for n, g in state_dict_of(jg).items()}
    for i in range(3):
        bi = batch(seed=10 + i, b=2)
        gs, _, ws = jgrad(jstate.params, _jbatch(bi))
        for n, g in state_dict_of(jax.tree_util.tree_map(lambda g: g / ws, gs)).items():
            mask[n] &= g.abs() >= TINY_G
        jstate, jlv = jstep(jstate, _jbatch(bi))
        state, lv = step(state, to_torch(bi))
        assert abs(float(lv) - float(jlv)) <= 1e-5 * abs(float(jlv)), i
    p_worst, left_out = _param_diff(state.module, jstate.params, mask)
    n_total = sum(p.numel() for p in state.module.parameters())
    print(f"f32 step: loss rel diff {loss_err:.2e} (tol {LOSS_RTOL:.0e}); gradients largest "
          f"max|diff|/max|g| {g_worst:.2e} (tol {GRAD_RTOL:.0e}); parameters after 3 Adam "
          f"steps max|diff| {p_worst:.2e} (tol {PARAM_ATOL:.0e}), {left_out} of {n_total} "
          f"entries with |g| < {TINY_G:.0e} left out")
    assert loss_err <= LOSS_RTOL and p_worst <= PARAM_ATOL
    assert state.step == 3 and int(jstate.step) == 3


def test_accumulation_matches_jax_and_one_big_batch_with_a_padded_tail(setup):
    tx = ts.Tx(LR)
    jtx = _jax_tx()
    full = batch(seed=3, b=3)
    micro = [{k: v[:2] for k, v in full.items()},
             {k: np.concatenate([v[2:], v[2:]]) for k, v in full.items()}]
    micro[0]["weight"] = np.ones(2, np.float32)
    micro[1]["weight"] = np.array([1, 0], np.float32)  # the padded row counts for nothing

    state = _port_state(setup, tx)
    grad_step, apply_step = ts.make_accum_steps(ts.clamped_apply, setup["tloss"], tx)
    acc = None
    for m in micro:
        acc = ts.accum_add(acc, grad_step(state, to_torch(m)))
    grads = {n: g / acc[1] for n, g in _grads_of(state.module).items()}
    state, loss = apply_step(state, *acc)

    jgrad, japply = jsteps.make_accum_steps(setup["japply"], setup["jloss"], jtx,
                                            mesh=setup["mesh"], donate=False)
    jacc = None
    for m in micro:
        jacc = jsteps.accum_add(jacc, jgrad(setup["params"], _jbatch(m)))
    jg = jax.tree_util.tree_map(lambda g: g / jacc[2], jacc[0])
    jstate, jloss = japply(jsteps.TrainState.create(setup["params"], jtx), *jacc)
    g_worst, _ = _compare_tree(grads, jg, GRAD_RTOL, "accumulated grad")
    mask = {n: g.abs() >= TINY_G for n, g in state_dict_of(jg).items()}
    p_worst, left_out = _param_diff(state.module, jstate.params, mask)

    big = _port_state(setup, tx)
    big, big_loss = ts.make_train_step(ts.clamped_apply, setup["tloss"], tx)(big, to_torch(full))
    big_worst = max(float((p - q).abs().max()) for p, q in
                    zip(state.module.parameters(), big.module.parameters()))
    print(f"accumulation k=2 (padded tail): gradients vs JAX {g_worst:.2e} x max|g|, params "
          f"vs JAX {p_worst:.2e} ({left_out} tiny-|g| entries left out), loss "
          f"{float(loss):.7f} vs JAX {float(jloss):.7f} vs one batch {float(big_loss):.7f}; "
          f"params vs one batch max|diff| {big_worst:.2e} (tol {PARAM_ATOL:.0e})")
    assert float(acc[1]) == 3.0 and p_worst <= PARAM_ATOL and big_worst <= PARAM_ATOL
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(loss) - float(big_loss)) <= 1e-5 * abs(float(big_loss))


@pytest.mark.parametrize("max_norm", [1e-4, 1e3], ids=["above_threshold", "below_threshold"])
def test_clip_matches_optax_clip_by_global_norm(setup, max_norm):
    g = np.random.default_rng(5)
    leaves = [g.normal(size=s).astype(np.float32) for s in ((3, 3, 4, 8), (8,), (17,))]
    tx = optax.clip_by_global_norm(max_norm)
    ref, _ = tx.update([jnp.asarray(a) for a in leaves], tx.init(None))
    ours = [torch.from_numpy(a.copy()) for a in leaves]
    norm = ts.clip_by_global_norm_(ours, max_norm)
    errs = [float(np.abs(o.numpy() - np.asarray(r)).max() / np.abs(np.asarray(r)).max())
            for o, r in zip(ours, ref)]
    want = float(optax.global_norm([jnp.asarray(a) for a in leaves]))
    print(f"clip {max_norm:g}: norm {float(norm):.7f} vs optax {want:.7f}; clipped gradients "
          f"max rel diff {max(errs):.2e} (tol 1e-6)")
    assert abs(float(norm) - want) <= 1e-6 * want and max(errs) <= 1e-6
    if max_norm > want:
        assert all(np.array_equal(o.numpy(), a) for o, a in zip(ours, leaves))

    # a clipped train step against JAX's chain(clip, adam)
    b = batch(seed=6, b=2)
    state = _port_state(setup, ts.Tx(LR, clip=max_norm))
    state, loss = ts.make_train_step(ts.clamped_apply, setup["tloss"],
                                     ts.Tx(LR, clip=max_norm))(state, to_torch(b))
    jtx = _jax_tx(max_norm)
    jstate, jloss = jsteps.make_train_step(setup["japply"], setup["jloss"], jtx, setup["mesh"],
                                           donate=False)(
        jsteps.TrainState.create(setup["params"], jtx), _jbatch(b))
    jgrad, _ = jsteps.make_accum_steps(setup["japply"], setup["jloss"], _jax_tx(),
                                       mesh=setup["mesh"], donate=False)
    gsum, _, wsum = jgrad(setup["params"], _jbatch(b))
    mask = {n: x.abs() >= TINY_G for n, x in state_dict_of(
        jax.tree_util.tree_map(lambda x: x / wsum, gsum)).items()}
    p_worst, left_out = _param_diff(state.module, jstate.params, mask)
    print(f"clipped step: params max|diff| {p_worst:.2e} (tol {PARAM_ATOL:.0e}, {left_out} "
          "tiny-|g| entries left out)")
    assert p_worst <= PARAM_ATOL


def test_bf16_step_matches_jax_bf16_and_keeps_f32_masters(setup):
    b = batch(seed=7, b=2)
    tx = ts.Tx(LR)
    ref = {}
    for name, dtype in (("bf16", jnp.bfloat16), ("f32", None)):
        jgrad, _ = jsteps.make_accum_steps(setup["japply"], setup["jloss"], _jax_tx(),
                                           mesh=setup["mesh"], donate=False, compute_dtype=dtype)
        gsum, jlsum, jwsum = jgrad(setup["params"], _jbatch(b))
        ref[name] = (state_dict_of(jax.tree_util.tree_map(lambda g: g / jwsum, gsum)),
                     float(jlsum / jwsum))
    state = _port_state(setup, tx)
    grad_step, apply_step = ts.make_accum_steps(ts.clamped_apply, setup["tloss"], tx,
                                                compute_dtype=torch.bfloat16)
    lsum, wsum = grad_step(state, to_torch(b))
    assert lsum.dtype == torch.float32
    grads = {n: g / wsum for n, g in _grads_of(state.module).items()}
    assert all(g.dtype == torch.float32 for g in grads.values())
    loss_err = abs(float(lsum / wsum) - ref["bf16"][1]) / abs(ref["bf16"][1])

    def err(a, r):
        return float((a - r).abs().max()) / float(r.abs().max())

    weights = {n: err(g, ref["bf16"][0][n]) for n, g in grads.items() if n.endswith("weight")}
    biases = {n: err(g, ref["f32"][0][n]) for n, g in grads.items() if n.endswith("bias")}
    jax_biases = max(err(ref["bf16"][0][n], ref["f32"][0][n]) for n in biases)
    state, _ = apply_step(state, lsum, wsum)
    assert all(p.dtype == torch.float32 for p in state.module.parameters())
    print(f"bf16 step: loss {float(lsum / wsum):.6f} vs JAX bf16 {ref['bf16'][1]:.6f} (rel "
          f"{loss_err:.2e}, tol 1e-3); weight gradients vs JAX bf16, largest "
          f"max|diff|/max|g| {max(weights.values()):.2e}; bias gradients vs the f32 gradient "
          f"{max(biases.values()):.2e} (tol {BF16_RTOL:.0e} each; JAX's bf16 bias gradients on "
          f"the CPU are {jax_biases:.2e} from f32: XLA's bf16 reduction over the pixels)")
    assert loss_err <= 1e-3
    assert max(weights.values()) <= BF16_RTOL and max(biases.values()) <= BF16_RTOL
