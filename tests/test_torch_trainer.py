"""The port's `Trainer` (`train/loop.py`) against the JAX package's, on the CPU.

The esr_gen generator at 4 filters and 1 RRDB on the BoringDataset (32
samples, 32^2 -> 64^2, batch 8), trained through the S2D route
(`s2d_train = true`, as both shipped run configs train) with the run
config's sqrt-scaled loss (l1 0.3 + psnr 0.4 + ssim 0.3; MS-SSIM needs 208
px). Both trainers start from JAX's `init_state(0)` parameters (the port's
own initializers cannot draw JAX's numbers); JAX's runs on a one-device
mesh.

* `fit` for 2 epochs: per-epoch train/loss and val/loss within 1e-5
  relative of JAX's, the history's keys equal to JAX's, and the files a fit
  leaves (checkpoints, best.json, history.jsonl, TB events) in place;
  `test` from the best checkpoint, also within 1e-5 per metric.
* Resume: 2 epochs, then a third resumed from the latest checkpoint, is
  bitwise the third epoch of an uninterrupted 3-epoch fit.
* Early stopping with `patience` and `min_delta`; an empty split gives a
  NaN loss; an exception saves the live state as the emergency snapshot,
  and the host mirror when the live state cannot be read.
* The refusals: accelerator "tpu", "cpu" on another device.
"""

import importlib
import json
import math

import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)
from _torch_train_common import LOSS_WEIGHTS, SQRT_TABLE, configs, jcfg, state_dict_of, tcfg

from xmm_superres_denoise_torch.data.datamodule import XmmDataModule
from xmm_superres_denoise_torch.train import Trainer, create_loss
from xmm_superres_denoise_torch.train import loop as tloop
from xmm_superres_denoise_torch.utils.tbevents import read_scalar_events

jdm = importlib.import_module("xmm_superres_denoise_tpu.data.datamodule")
jtrain = importlib.import_module("xmm_superres_denoise_tpu.train")
jmesh = importlib.import_module("xmm_superres_denoise_tpu.parallel.mesh")

RTOL = 1e-5
METRICS = ["psnr", "l1"]
SEED = 1  # the port's own init from seed 1 gives outputs inside (0, 1) on this data


def _port(tmp_path, jax_params=None, boring_size=32, **kw):
    ds, mc, tc = configs(tcfg, tmp_path, s2d_train=True, **kw)
    dm = XmmDataModule(ds, splits_root=tmp_path / "splits", boring_size=boring_size,
                       device="cpu")
    tr = Trainer(mc, tc, dm, create_loss(SQRT_TABLE, tcfg.LossCfg(**LOSS_WEIGHTS)),
                 metric_names=METRICS, device="cpu")
    if jax_params is not None:
        start = state_dict_of(jax_params)
        init = tr.init_state
        tr.init_state = lambda seed=0, params=None: init(seed, params or start)
    return tr


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_fit_and_test_match_the_jax_trainer(tmp_path):
    ds, mc, tc = configs(jcfg, tmp_path / "jax", s2d_train=True)
    jdmod = jdm.XmmDataModule(ds, splits_root=tmp_path / "jax/splits", boring_size=32)
    jtr = jtrain.Trainer(mc, tc, jdmod, jtrain.create_loss(SQRT_TABLE,
                                                           jcfg.LossCfg(**LOSS_WEIGHTS)),
                         mesh=jmesh.make_mesh(data=1, fsdp=1), metric_names=METRICS)
    jparams = jtr.init_state(0).params
    jres = jtr.fit(seed=0)
    jtest = jtr.test(extended=False)

    tr = _port(tmp_path / "port", jparams)
    res = tr.fit(seed=0)
    test = tr.test(extended=False)

    rows = []
    for e, (a, b) in enumerate(zip(res.history, jres.history)):
        assert sorted(a) == sorted(b)
        for key in ("train/loss", "val/loss"):
            rows.append((e, key, a[key], b[key], _rel(a[key], b[key])))
    worst_test = max(_rel(test[k], jtest[k]) for k in jtest)
    for e, key, a, b, r in rows:
        print(f"epoch {e} {key}: port {a:.8f} JAX {b:.8f} (rel {r:.1e}, tol {RTOL:.0e})")
    print(f"test from the best checkpoint: {len(test)} metrics, largest rel diff {worst_test:.1e}")
    assert len(res.history) == len(jres.history) == 2
    assert all(r <= RTOL for *_, r in rows) and worst_test <= RTOL
    assert sorted(test) == sorted(jtest) and res.best_step == jres.best_step

    root = tr.ckpt.root
    assert (root / "best.json").exists() and sorted(
        int(p.stem) for p in (root / "ckpts").glob("*.pt")) == [1, 2]
    history = [json.loads(line) for line in (root / "history.jsonl").read_text().splitlines()]
    assert [h["epoch"] for h in history] == [0, 1]
    events = read_scalar_events(next((root / "tb").glob("events.out.tfevents.*")))
    assert {tag for _, _, tag, _ in events} >= {"train/loss", "val/loss"}


def test_resume_continues_bitwise_as_one_fit(tmp_path):
    straight_tr = _port(tmp_path / "a", epochs=3)
    straight = straight_tr.fit(seed=SEED)
    trained = straight_tr._live_state.module.state_dict()
    init = straight_tr.init_state(SEED).module.state_dict()
    assert not all(torch.equal(trained[k], init[k]) for k in init)  # it trained
    tr = _port(tmp_path / "b", epochs=2)
    tr.fit(seed=SEED)
    tr.trainer_config.epochs = 3
    resumed = tr.fit(seed=SEED, resume=True)
    print(f"epoch 2 val/loss: straight {straight.history[2]['val/loss']!r}, resumed "
          f"{resumed.history[0]['val/loss']!r}")
    assert len(resumed.history) == 1 and resumed.history[0]["epoch"] == 2
    for key in ("train/loss", "val/loss"):
        assert resumed.history[0][key] == straight.history[2][key]


def test_early_stopping_with_patience_and_min_delta(tmp_path):
    res = _port(tmp_path, epochs=5, early_stopping_patience=1,
                early_stopping_min_delta=1e9).fit(seed=SEED)
    assert len(res.history) == 2  # the first epoch improves on inf, the second by less than min_delta
    res = _port(tmp_path / "off", epochs=3, early_stopping_patience=0).fit(seed=SEED)
    assert len(res.history) == 3


def test_empty_split_gives_nan_loss(tmp_path):
    tr = _port(tmp_path, boring_size=8)  # the remainder rule gives the test split 0 samples
    assert len(tr.dm.split_indices("test")) == 0
    logs = tr._run_eval(tr.init_state(0), "test", "test", include_input_metrics=False)
    assert math.isnan(logs["test/loss"])


def test_emergency_snapshot_is_the_live_state(tmp_path, monkeypatch):
    tr = _port(tmp_path)
    monkeypatch.setattr(tr, "_run_eval", lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("injected mid-fit failure")))
    with pytest.raises(RuntimeError, match="injected"):
        tr.fit(seed=SEED)
    restored = tr.ckpt.restore_emergency(tr.init_state(0))
    assert restored.step == 4  # the epoch's 4 train steps, none lost
    live = tr._live_state.module.state_dict()
    assert all(torch.equal(v, restored.module.state_dict()[k]) for k, v in live.items())


def test_emergency_snapshot_falls_back_to_the_host_mirror(tmp_path, monkeypatch):
    tr = _port(tmp_path)
    real_step, real_snapshot = tr._train_step, tloop.snapshot
    calls = {"step": 0, "snapshot": 0}

    def step(state, batch):
        if calls["step"] == 2:
            raise RuntimeError("injected step crash")
        calls["step"] += 1
        return real_step(state, batch)

    def snapshot(state):  # the first (the mirror, after step 1) works; the live read fails
        calls["snapshot"] += 1
        if calls["snapshot"] > 1:
            raise RuntimeError("state unreadable")
        return real_snapshot(state)

    monkeypatch.setattr(tr, "_train_step", step)
    monkeypatch.setattr(tloop, "snapshot", snapshot)
    with pytest.raises(RuntimeError, match="injected step crash"):
        tr.fit(seed=SEED)
    restored = tr.ckpt.restore_emergency(tr.init_state(0))
    assert restored.step == 1
    mirror = tr._host_snapshot["model"]
    assert all(torch.equal(v, restored.module.state_dict()[k]) for k, v in mirror.items())


@pytest.mark.parametrize("case", ["tpu", "cpu_elsewhere"])
def test_refusals(tmp_path, case):
    ds, mc, tc = configs(tcfg, tmp_path)
    if case == "tpu":
        tc.accelerator = "tpu"
    else:
        tc.accelerator = "cpu"
    device = "meta" if case == "cpu_elsewhere" else "cpu"
    dm = XmmDataModule(ds, splits_root=tmp_path / "splits", boring_size=8, device=device)
    want = {"tpu": "CUDA card or the CPU", "cpu_elsewhere": "device='cpu'"}[case]
    with pytest.raises(RuntimeError, match=want):
        Trainer(mc, tc, dm, create_loss(None, tcfg.LossCfg(l1=1.0)), device=device)
