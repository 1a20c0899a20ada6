"""The port's checkpoints (`train/checkpoints.py`) on the CPU.

* A checkpoint holds the model's and Adam's state and the step: restoring
  it into a fresh state gives bitwise the same parameters and moments, and
  the next step from either state is bitwise the same.
* Retention keeps the latest checkpoint and the best 3 by val/loss, and
  `best.json` names the best; resume-from-latest survives a val/loss that
  gets worse (the JAX package once lost it to a best-only policy).
* A NaN val/loss is kept for resume but is never "best".
* The emergency snapshot round-trips apart from the stepped checkpoints.
* `save_params_npz` writes the Flax key layout: the JAX package's
  `load_params_npz` reads it into the Flax template bitwise, and the port's
  `params_from_flax` reads it back into the same state_dict.
"""

import importlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)
from _torch_train_common import batch, to_torch

from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_SR
from xmm_superres_denoise_torch.train import checkpoints as tck
from xmm_superres_denoise_torch.train import steps as ts
from xmm_superres_denoise_torch.train.loss import create_loss
from xmm_superres_denoise_torch.config.schema import LossCfg
from xmm_superres_denoise_torch.utils.weights import params_from_flax

jck = importlib.import_module("xmm_superres_denoise_tpu.train.checkpoints")
jrrdb = importlib.import_module("xmm_superres_denoise_tpu.models.rrdb")

TX = ts.Tx(1e-3)


def _state(seed=1):  # seed 1: outputs inside (0, 1), so the clamp passes gradients
    model = GeneratorRRDB_SR(num_filters=4, num_res_blocks=1)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return ts.TrainState.create(model, TX)


def _step():
    return ts.make_train_step(ts.clamped_apply, create_loss(None, LossCfg(l1=1.0)), TX)


def test_checkpoint_round_trip_restores_model_adam_and_step(tmp_path):
    step = _step()
    state, _ = step(_state(), to_torch(batch(seed=0, b=2, lr_res=16)))
    assert not all(torch.equal(p, q) for p, q in zip(state.module.parameters(),
                                                     _state().module.parameters()))
    mgr = tck.CheckpointManager(tmp_path / "run")
    mgr.save(1, state, 0.5)
    fresh, at = mgr.restore(_state(seed=9))
    assert at == 1 and fresh.step == 1
    for (n, p), q in zip(state.module.named_parameters(), fresh.module.parameters()):
        assert torch.equal(p, q), n
    for p, q in zip(state.module.parameters(), fresh.module.parameters()):
        a, b = state.optimizer.state[p], fresh.optimizer.state[q]
        assert all(torch.equal(a[k], b[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    nxt = to_torch(batch(seed=1, b=2, lr_res=16))
    state, la = step(state, nxt)
    fresh, lb = step(fresh, nxt)
    assert torch.equal(la, lb)
    assert all(torch.equal(p, q) for p, q in zip(state.module.parameters(),
                                                 fresh.module.parameters()))


def test_retention_keeps_the_latest_and_the_best_three(tmp_path):
    mgr = tck.CheckpointManager(tmp_path / "run", max_to_keep=3)
    state = _state()
    losses = [5.0, 4.0, 3.0, 6.0, 7.0, 8.0]  # val/loss gets worse after step 3
    for i, v in enumerate(losses, start=1):
        mgr.save(i, state, v)
    kept = sorted(int(p.stem) for p in (tmp_path / "run/ckpts").glob("*.pt"))
    print(f"kept steps {kept}; best.json {mgr.best_metadata()}")
    assert kept == [1, 2, 3, 6] and mgr.latest_step() == 6
    assert mgr.best_metadata() == {"step": 3, "val_loss": 3.0}
    assert mgr.restore(state)[1] == 6 and mgr.restore_best(state)[1] == 3


def test_nan_val_loss_is_kept_but_never_best(tmp_path):
    mgr = tck.CheckpointManager(tmp_path / "run")
    state = _state()
    mgr.save(1, state, float("nan"))
    assert mgr.best_metadata() is None and mgr.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        mgr.restore_best(state)
    mgr.save(2, state, 2.0)
    mgr.save(3, state, float("nan"))
    assert mgr.best_metadata() == {"step": 2, "val_loss": 2.0}
    assert mgr.latest_step() == 3
    index = json.loads((tmp_path / "run/ckpts/index.json").read_text())
    assert math.isinf(index["1"]) and math.isinf(index["3"])


def test_emergency_snapshot_round_trips_apart_from_the_stepped_ones(tmp_path):
    state, _ = _step()(_state(), to_torch(batch(seed=2, b=2, lr_res=16)))
    mgr = tck.CheckpointManager(tmp_path / "run")
    path = mgr.save_emergency(tck.snapshot(state))
    assert path.name == "emergency.pt" and mgr.latest_step() is None
    fresh = mgr.restore_emergency(_state(seed=5))
    assert fresh.step == 1
    assert all(torch.equal(p, q) for p, q in zip(state.module.parameters(),
                                                 fresh.module.parameters()))
    with pytest.raises(FileNotFoundError):
        tck.CheckpointManager(tmp_path / "other").restore_emergency(fresh)


def test_flax_npz_is_read_by_jax_and_by_the_port(tmp_path):
    model = _state(seed=3).module
    path = tmp_path / "w.npz"
    tck.save_params_npz(path, model.state_dict())
    template = jax.eval_shape(jrrdb.GeneratorRRDB_SR(num_filters=4, num_res_blocks=1).init,
                              jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)))
    loaded = jck.load_params_npz(path, template)
    back = params_from_flax(jax.tree_util.tree_map(np.asarray, loaded))
    assert sorted(back) == sorted(model.state_dict())
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    assert all(torch.equal(params_from_flax(path)[k], v) for k, v in model.state_dict().items())
    arrays = tck.load_params_npz(path, model)
    assert arrays["trunk/conv_first/kernel"].shape == (3, 3, 1, 4)  # HWIO, as JAX keeps it
