"""Data parallelism of the port's training on the CPU: two (or four)
processes on `gloo` (`torch.multiprocessing`, spawn, 120 s per test), each
on its rank's share of one global batch padded with
`data/datamodule.py: pad_batch` (B = 3 over 2 or 4 ranks: 4 rows, the
padded row weighted 0).

* DDP (`parallel/sharding.py: wrap_ddp`, the S2D training route): one
  step equals the one-process step on the unpadded batch of 3.
* FSDP2 (`shard_fsdp`, the model route, clipped below the gradient norm
  so the clip's global norm spans the shards), on a 1 x 2 mesh and, in
  four processes, as HSDP on a 2 x 2 (data x fsdp) mesh: one step equals
  it too. The same on a 1 x 2 mesh for a tiny DRCT (each Swin block a
  unit of its own, `memory_efficient` checkpoints inside them, as
  `drct_sr_fsdp.toml` trains).
* Eval after that FSDP step (under `no_grad` the dense blocks run from a
  kernel pack, which FSDP must not leave stale) equals the one-process eval
  of the stepped model, and eval before it the eval of the initial one.
* The eval step's `group` all-reduce with the core collections (psnr,
  ssim, l1, l2 and the mean-style poisson) gives the one-process states.
* The emergency snapshot under FSDP: a `Trainer` fit on a 1 x 2 mesh,
  its host mirror forced after every step, one rank raising in
  `step_callback` mid-epoch; rank 0 writes the mirror as `emergency.pt`
  without waiting on the failed rank, and it restores bitwise.

The esr_gen generator at 4 filters, 1 RRDB, 16^2 -> 32^2, seeded (the
DRCT at embed 12, one group of 5 blocks, window 4, seeded); the
parameters after the step to 1e-3 x lr (entries with |g| < 1e-6 in the
one-process step left out, as in `test_torch_train_step.py`), the losses
and the eval states to 1e-6 relative.
"""

import os
import socket
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)
from _torch_train_common import LOSS_WEIGHTS, SQRT_TABLE, batch, configs, to_torch

from xmm_superres_denoise_torch.config.schema import LossCfg
from xmm_superres_denoise_torch.data.datamodule import pad_batch
from xmm_superres_denoise_torch.metrics.collection import XMMMetricCollection
from xmm_superres_denoise_torch.models.drct import DRCT
from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_SR
from xmm_superres_denoise_torch.ops.s2d_forward import make_s2d_train_apply
from xmm_superres_denoise_torch.ops.stretch import Normalizer
from xmm_superres_denoise_torch.train import steps as ts
from xmm_superres_denoise_torch.train.loss import create_loss

LR = 1e-4
TIMEOUT_S = 120
PARAM_ATOL, RTOL, TINY_G = 1e-3 * LR, 1e-6, 1e-6
NAMES = ("psnr", "ssim", "l1", "l2", "poisson")


def _model(mode="fsdp"):
    if mode == "fsdp-drct":
        model = DRCT(img_size=16, patch_size=4, in_chans=1, embed_dim=12, depths=(1,),
                     num_heads=(2,), window_size=4, mlp_ratio=2.0, gc=6, num_feat=8,
                     use_checkpoint=True)
    else:
        model = GeneratorRRDB_SR(num_filters=4, num_res_blocks=1)
    # seed 1: its outputs on this batch lie inside (0, 1), so the clamp passes gradients
    model.reset_parameters(torch.Generator().manual_seed(1))
    return model


def _global_batch():
    return batch(seed=4, b=3, lr_res=16)


def _loss():
    return create_loss(None, LossCfg(l1=0.5, ssim=0.5))


def _colls():
    ds = Normalizer(0.0022336, 0.0005584, "sqrt")
    return {"metrics": XMMMetricCollection(ds, [Normalizer(0.0022336, 0.0005584, "linear")],
                                           "val", metric_names=NAMES)}


def _eval(apply, batch_, group):
    colls = _colls()
    step = ts.make_eval_step(apply, _loss(), {k: c.update for k, c in colls.items()},
                             upsample_input=2, group=group)
    states, ls, n = step({k: c.init("cpu") for k, c in colls.items()}, batch_)
    return {"loss_sum": ls, "n": n, "states": states}


MESHES = {"ddp": (2, 1), "fsdp": (1, 2), "hsdp": (2, 2), "fsdp-drct": (1, 2),
          "fsdp-emergency": (1, 2)}  # (data, fsdp)
FAIL_RANK, FAIL_AT_STEP = 1, 2


def _env(rank, port, world):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)


def _worker(rank, port, mode, out):
    data, fsdp = MESHES[mode]
    world = data * fsdp
    _env(rank, port, world)
    from xmm_superres_denoise_torch.parallel import (
        initialize_distributed,
        make_mesh,
        shard_fsdp,
        wrap_ddp,
    )

    initialize_distributed("cpu")
    try:
        padded, valid = pad_batch(_global_batch(), world)
        rows = len(padded["lr"])
        padded["weight"] = (np.arange(rows) < valid).astype(np.float32)
        per = rows // world
        share = to_torch({k: v[per * rank: per * (rank + 1)] for k, v in padded.items()})
        model = _model(mode)
        result = {}
        if mode == "ddp":
            module = wrap_ddp(model, make_mesh("auto", 1, "cpu"), torch.device("cpu"))
            apply, tx = make_s2d_train_apply(model), ts.Tx(LR)
            result["eval_group"] = _eval(lambda x: ts.clamped_apply(module, x), share,
                                         dist.group.WORLD)
        else:
            from torch.distributed.fsdp import FSDPModule

            module = shard_fsdp(model, make_mesh(data, fsdp, "cpu"))
            result["units"] = sum(isinstance(m, FSDPModule) for m in module.modules())
            apply, tx = ts.clamped_apply, ts.Tx(LR, clip=1e-3)
            result["eval_before"] = _eval(lambda x: apply(module, x), share, dist.group.WORLD)
        state = ts.TrainState.create(module, tx)
        step = (ts.make_train_step if mode == "ddp" else ts.make_fsdp_train_step)(
            apply, _loss(), tx, group=dist.group.WORLD)
        state, result["loss"] = step(state, share)
        if mode != "ddp":
            result["eval_after"] = _eval(lambda x: apply(module, x), share, dist.group.WORLD)
        from xmm_superres_denoise_torch.train.checkpoints import snapshot

        result["params"] = snapshot(state)["model"]
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


def _emergency_worker(rank, port, mode, out):
    """A 1 x 2 FSDP fit of the esr_gen generator (4 filters, 1 RRDB, boring
    32^2 -> 64^2, batch 8: 4 steps an epoch), the mirror taken after every
    step; rank FAIL_RANK raises after step FAIL_AT_STEP. Rank 0 saves what
    it caught, its mirror and where the emergency snapshot lies."""
    _env(rank, port, 2)
    from xmm_superres_denoise_torch import config as tcfg
    from xmm_superres_denoise_torch.data.datamodule import XmmDataModule
    from xmm_superres_denoise_torch.parallel import initialize_distributed
    from xmm_superres_denoise_torch.train import Trainer
    from xmm_superres_denoise_torch.train import loop as tloop

    initialize_distributed("cpu")
    try:
        tloop._SNAPSHOT_INTERVAL_S = 0.0  # force a mirror after every step
        root = Path(out).parent
        ds, mc, tc = configs(tcfg, root, mesh=tcfg.MeshCfg(data=1, fsdp=2), epochs=1)
        dm = XmmDataModule(ds, splits_root=root / f"splits{rank}", boring_size=32,
                           device="cpu")
        tr = Trainer(mc, tc, dm, create_loss(SQRT_TABLE, LossCfg(**LOSS_WEIGHTS)),
                     metric_names=["l1"], device="cpu")
        steps = []

        def fail_mid_epoch():
            steps.append(len(steps) + 1)
            if rank == FAIL_RANK and steps[-1] == FAIL_AT_STEP:
                raise RuntimeError(f"injected failure on rank {rank} after step {steps[-1]}")

        tr.step_callback = fail_mid_epoch
        result = {"error": None}
        try:
            tr.fit(seed=1)
        except RuntimeError as e:  # the injected failure, or gloo's on the other rank
            result["error"] = f"{type(e).__name__}: {e}"
        if rank == 0:
            result.update(steps=len(steps), mirror=tr._host_snapshot,
                          emergency=str(tr.ckpt.root / "emergency.pt"))
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


def _spawn(mode, tmp_path, worker=_worker):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / f"{mode}.pt"
    world = MESHES[mode][0] * MESHES[mode][1]
    ctx = mp.start_processes(worker, args=(port, mode, str(out)), nprocs=world, join=False,
                             start_method="spawn")
    import time

    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{mode}: {world} processes still running after {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return torch.load(out, weights_only=False)


def _one_process(apply, tx, mode="fsdp"):
    """The one-process step on the unpadded batch; the gradient mask."""
    model = _model(mode)
    state = ts.TrainState.create(model, tx)
    grad_step, apply_step = ts.make_accum_steps(apply, _loss(), tx)
    lsum, wsum = grad_step(state, to_torch(_global_batch()))
    mask = {n: (p.grad / wsum).abs() >= TINY_G for n, p in model.named_parameters()}
    norm = ts.global_norm([p.grad / wsum for p in model.parameters()])
    assert float(norm) > max(tx.clip, 0.0)  # a gradient, and an active clip where one is set
    state, loss = apply_step(state, lsum, wsum)
    return model, loss, mask


def _param_diff(params, model, mask):
    ref = dict(model.named_parameters())
    diffs = [(params[n] - ref[n].detach()).abs()[mask[n]] for n in ref]
    return max(float(d.max()) if d.numel() else 0.0 for d in diffs)


def _eval_diff(got, want):
    errs = [abs(float(got["loss_sum"]) - float(want["loss_sum"])) / abs(float(want["loss_sum"]))]
    assert float(got["n"]) == float(want["n"]) == 3.0
    for name, (s, c) in got["states"]["metrics"]["linear"].items():
        s0, c0 = want["states"]["metrics"]["linear"][name]
        errs += [abs(float(s) - float(s0)) / max(abs(float(s0)), 1e-12),
                 abs(float(c) - float(c0)) / max(abs(float(c0)), 1e-12)]
    return max(errs)


def test_ddp_step_on_a_padded_batch_is_the_one_process_step(tmp_path):
    got = _spawn("ddp", tmp_path)
    model, loss, mask = _one_process(make_s2d_train_apply(_model()), ts.Tx(LR))
    p = _param_diff(got["params"], model, mask)
    ev = _eval_diff(got["eval_group"], _eval(lambda x: ts.clamped_apply(_model(), x),
                                             to_torch(_global_batch()), None))
    print(f"DDP x2 (gloo), B=3 padded to 4: loss {float(got['loss']):.8f} vs one process "
          f"{float(loss):.8f}; params max|diff| {p:.2e} (tol {PARAM_ATOL:.0e}); eval step with "
          f"the group: largest rel diff of loss and states {ev:.2e} (tol {RTOL:.0e})")
    assert abs(float(got["loss"]) - float(loss)) <= RTOL * abs(float(loss))
    assert p <= PARAM_ATOL and ev <= RTOL


@pytest.mark.parametrize("mode", ["fsdp", "hsdp", "fsdp-drct"])
def test_fsdp_step_and_eval_after_it(tmp_path, mode):
    got = _spawn(mode, tmp_path)
    tx = ts.Tx(LR, clip=1e-3)
    model, loss, mask = _one_process(ts.clamped_apply, tx, mode)
    p = _param_diff(got["params"], model, mask)
    full = to_torch(_global_batch())
    with torch.no_grad():
        before = _eval_diff(got["eval_before"],
                            _eval(lambda x: ts.clamped_apply(_model(mode), x), full, None))
        after = _eval_diff(got["eval_after"],
                           _eval(lambda x: ts.clamped_apply(model, x), full, None))
    data, fsdp = MESHES[mode]
    # a unit per RRDB and the root; per Swin block (5 in the DRCT's group) and the root
    assert got["units"] == (6 if mode == "fsdp-drct" else 2)
    print(f"{mode} mesh {data}x{fsdp} (FSDP2, gloo, clip 1e-3, {got['units']} units), B=3 padded to 4: loss {float(got['loss']):.8f} vs "
          f"one process {float(loss):.8f}; params max|diff| {p:.2e} (tol {PARAM_ATOL:.0e}); eval "
          f"before the step {before:.2e}, after it {after:.2e} (tol {RTOL:.0e})")
    assert abs(float(got["loss"]) - float(loss)) <= RTOL * abs(float(loss))
    assert p <= PARAM_ATOL and before <= RTOL and after <= RTOL


def test_fsdp_emergency_snapshot_is_the_host_mirror(tmp_path):
    got = _spawn("fsdp-emergency", tmp_path, _emergency_worker)
    mirror = got["mirror"]
    assert got["error"] is not None and mirror is not None
    # rank 0 stepped on until the failed rank left the broadcast after step
    # FAIL_AT_STEP, so its last mirror is of the step before
    assert got["steps"] == FAIL_AT_STEP and mirror["step"] == FAIL_AT_STEP - 1
    model = _model()
    state = ts.TrainState.create(model, ts.Tx(LR))
    from xmm_superres_denoise_torch.train.checkpoints import CheckpointManager

    path = Path(got["emergency"])
    restored = CheckpointManager(path.parent).restore_emergency(state)
    params = restored.module.state_dict()
    same = [torch.equal(v, params[k]) for k, v in mirror["model"].items()]
    print(f"FSDP 1x2 (gloo): rank 0 caught {got['error'][:120]!r}; emergency.pt holds the "
          f"mirror of step {mirror['step']}, {sum(same)}/{len(same)} tensors bitwise equal "
          f"after restore_emergency")
    assert path.exists() and restored.step == mirror["step"]
    assert sorted(mirror["model"]) == sorted(params) and all(same)
    assert mirror["optimizer"] is not None and restored.optimizer.state
