"""Fit/test orchestration: the port of the JAX package's `train/loop.py`.

    epoch:
      train: a train step per batch (the rank's share of the global batch;
             DDP or FSDP2 across processes), or k accumulated micro-batches
             per optimizer step, a shorter tail included
      val:   the eval step accumulating the loss and the collections on the
             device (all-reduced across processes), computed at epoch end;
             the input-baseline metrics on the first val pass only
      images: every `log_images_every_n_epochs`, the display batch's panels
             and FITS (`utils/imagelogger.py`; rank 0 writes)
      ckpt:  a torch checkpoint per epoch, best tracked on val/loss (min)
    test:  the same eval path with the extended and input-baseline
           collections, from the best (or given) state.

The forward is `clamped_apply` of the model (deterministic: a transformer's
drop path draws nothing, as JAX's trainer passes no rngs), or with
`model.s2d_train` the S2D training route of an RRDB generator
(`ops/s2d_forward.py: make_s2d_train_apply`, the dense blocks on K1). f32
steps and every evaluation run with TF32 off (`true_f32`): f32 is the
parity class. bf16 steps leave TF32 as it is.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..config.schema import ModelCfg, TrainerCfg
from ..data.datamodule import XmmDataModule
from ..metrics.collection import CORE_METRIC_NAMES, XMMMetricCollection
from ..models.registry import build_model
from ..ops.precision import true_f32
from ..ops.stretch import Normalizer
from ..parallel.distributed import is_primary
from .checkpoints import CheckpointManager, snapshot
from .loss import LossFn
from .steps import (
    TrainState,
    Tx,
    accum_add,
    clamped_apply,
    make_accum_steps,
    make_eval_step,
    make_fsdp_train_step,
    make_train_step,
)

log = logging.getLogger("xmmsr")

# Max staleness of the host-side state mirror that backs the emergency
# checkpoint when the live state cannot be read (on the card: after a
# sticky CUDA error).
_SNAPSHOT_INTERVAL_S = 60.0


@dataclass
class FitResult:
    best_val_loss: float
    best_step: int
    history: List[Dict[str, float]] = field(default_factory=list)


class Trainer:
    """`fit` and `test` of a registry model on `device` (`cuda:0` unless the
    caller asks for the CPU). In a process group (`parallel/distributed.py:
    initialize_distributed`) the run is data parallel over the group: DDP,
    or FSDP2 when `trainer.mesh.fsdp` > 1 (HSDP when `mesh.data` > 1 too);
    each rank's device is the caller's `device`."""

    def __init__(
        self,
        model_config: ModelCfg,
        trainer_config: TrainerCfg,
        datamodule: XmmDataModule,
        loss_fn: LossFn,
        scaling_normalizers: Optional[List[Normalizer]] = None,
        metric_names=None,
        device="cuda:0",
    ):
        self.model_config = model_config
        self.trainer_config = trainer_config
        self.metric_names = metric_names  # None -> CORE_METRIC_NAMES
        self.dm = datamodule
        self.loss_fn = loss_fn
        self.device = torch.device(device)
        cfg = datamodule.config
        self.lr_shape = (cfg.lr.res, cfg.lr.res)
        hr_res = cfg.hr.res if cfg.hr else cfg.lr.res
        self.hr_shape = (hr_res, hr_res)
        self.scale = self.hr_shape[0] // self.lr_shape[0]

        acc = trainer_config.accelerator
        if acc == "tpu":
            raise RuntimeError(
                "trainer.accelerator='tpu': the PyTorch port trains on a CUDA card or the "
                "CPU; use 'auto' (the trainer's device) or 'cpu'")
        if acc == "cpu" and self.device.type != "cpu":
            raise RuntimeError(
                f"trainer.accelerator='cpu' but the trainer's device is {self.device}; "
                "pass device='cpu' (the CLI's --device cpu)")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device}: no CUDA card is visible")
        if datamodule.device != self.device:
            raise ValueError(f"the data module prepares batches on {datamodule.device}, the "
                             f"trainer runs on {self.device}")
        self.distributed = dist.is_initialized()
        self.world = dist.get_world_size() if self.distributed else 1
        self.rank = dist.get_rank() if self.distributed else 0
        self.group = dist.group.WORLD if self.distributed else None
        self.mesh = None
        self._fsdp = trainer_config.mesh.fsdp > 1
        if self.distributed:
            from ..parallel.mesh import make_mesh

            self.mesh = make_mesh(trainer_config.mesh.data, trainer_config.mesh.fsdp,
                                  self.device.type)
        elif self._fsdp or trainer_config.mesh.data not in ("auto", 1):
            raise ValueError(
                f"trainer.mesh {trainer_config.mesh.data}x{trainer_config.mesh.fsdp} needs that "
                "many processes (torchrun); this process is alone")

        opt = model_config.optimizer
        # Lightning's gradient_clip_val (its global-norm algorithm); 0 disables
        self.tx = Tx(opt.learning_rate, tuple(opt.betas),
                     float(trainer_config.gradient_clip_val or 0.0))
        self.scaling_normalizers = scaling_normalizers or [
            Normalizer(
                lr_max=cfg.lr.clamp_max,
                hr_max=cfg.hr.clamp_max if cfg.hr else cfg.lr.clamp_max,
                mode="linear",
            )
        ]
        ckpt_root = trainer_config.checkpoint_root or Path("checkpoints")
        self.ckpt = CheckpointManager(Path(ckpt_root) / model_config.name.value)
        # the epoch image logger (log_images_every_n_epochs > 0): the fixed
        # display batch through the trainer's forward on its device
        self.image_logger = None
        self._display = None
        if trainer_config.log_images_every_n_epochs > 0:
            from ..data.display import XmmDisplayDataModule
            from ..utils.imagelogger import ImageLogger

            hr_exp = cfg.hr.exp if cfg.hr else cfg.lr.exps[0]
            self.image_logger = ImageLogger(
                out_dir=Path(ckpt_root) / model_config.name.value / "images",
                normalizer=self.dm.normalizer,
                log_every_n_epochs=trainer_config.log_images_every_n_epochs,
                lr_exp_ks=float(cfg.lr.exps[0]),
                hr_exp_ks=float(hr_exp),
                device=self.device,
            )
            self._display = XmmDisplayDataModule(self.dm)
        self._eval_cache = {}
        self._tb = None  # the TensorBoard event writer, made at the first history entry
        self._live_state = None

        self.model = build_model(model_config, self.lr_shape, self.hr_shape)
        if model_config.s2d_train:
            from ..models.rrdb import GeneratorRRDB_DN, GeneratorRRDB_SR
            from ..ops.s2d_forward import make_s2d_train_apply

            if not isinstance(self.model, (GeneratorRRDB_SR, GeneratorRRDB_DN)):
                raise ValueError("s2d_train=true is supported for the RRDB models only "
                                 f"(got {type(self.model).__name__})")
            # clips in the model's forward; memory_efficient checkpoints each dense block
            self._apply = make_s2d_train_apply(self.model, remat=model_config.memory_efficient)
        else:
            self._apply = clamped_apply
        # trainer.precision = "bf16": bf16 forward and backward, f32 masters,
        # loss and Adam (train/steps.py); evaluation always runs f32
        self._compute_dtype = torch.bfloat16 if trainer_config.precision == "bf16" else None
        self._accum = int(trainer_config.accumulate_grad_batches)
        args = (self._apply, self.loss_fn, self.tx, self.group, self._compute_dtype)
        if self._accum > 1:
            self._grad_step, self._apply_step = make_accum_steps(*args)
            self._train_step = None
        elif self._fsdp:
            self._train_step = make_fsdp_train_step(*args)
        else:
            self._train_step = make_train_step(*args)
        # per-epoch diagnostics hook: callable(epoch, state) -> dict merged
        # into that epoch's history entry (None = off)
        self.epoch_callback = None
        # called with no argument after each optimizer step (None = off);
        # `cli fit --profile` closes its trace window with it
        self.step_callback = None

    # ------------------------------------------------------------------ #

    def init_state(self, seed: int = 0, params=None) -> TrainState:
        """A fresh state: the model's parameters drawn from `seed` (the
        port's own initializers; it cannot draw JAX's numbers) or loaded
        from `params` (a state_dict), placed on the device and wrapped for
        the process group, with a fresh Adam."""
        model = build_model(self.model_config, self.lr_shape, self.hr_shape)
        if params is None:
            model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(params)
        model.to(self.device)
        if self.mesh is not None:
            from ..parallel.sharding import shard_fsdp, wrap_ddp

            module = shard_fsdp(model, self.mesh) if self._fsdp else wrap_ddp(
                model, self.mesh, self.device)
        else:
            module = model
        return TrainState.create(module, self.tx)

    def _make_collections(self, prefix: str, extended: bool):
        names = self.metric_names or CORE_METRIC_NAMES

        def coll(metric_names, input_baseline):
            return XMMMetricCollection(self.dm.normalizer, self.scaling_normalizers,
                                       prefix=prefix, metric_names=metric_names,
                                       input_baseline=input_baseline)

        colls = {"metrics": coll(names, False), "in:metrics": coll(names, True)}
        if extended:
            from ..metrics.extended import EXT_METRIC_NAMES

            colls["ext"] = coll(EXT_METRIC_NAMES, False)
            colls["in:ext"] = coll(EXT_METRIC_NAMES, True)
        return colls

    def _run_eval(
        self, state: TrainState, split: str, prefix: str, extended: bool = False,
        include_input_metrics: bool = True,
    ) -> Dict[str, float]:
        # the collections and their step are built once per configuration
        key = (prefix, extended, include_input_metrics)
        cached = self._eval_cache.get(key)
        if cached is None:
            colls = self._make_collections(prefix, extended)
            if not include_input_metrics:
                colls = {k: v for k, v in colls.items() if not k.startswith("in:")}
            cached = (colls, {k: v.update for k, v in colls.items()})
            self._eval_cache[key] = cached
        colls, updaters = cached
        eval_step = make_eval_step(
            lambda x: self._apply(state.module, x), self.loss_fn,
            metric_updaters=updaters, upsample_input=self.scale, group=self.group,
        )
        states = {k: v.init(self.device) for k, v in colls.items()}
        loss_sum = torch.zeros((), device=self.device)
        n = torch.zeros((), device=self.device)
        with true_f32():
            for batch in self.dm.loader(split, rank=self.rank, world_size=self.world):
                states, dl, dn = eval_step(states, batch)
                loss_sum, n = loss_sum + dl, n + dn
        if float(n) == 0.0:
            # an empty split must not report loss 0.0, which would be
            # recorded as a perfect "best" epoch
            log.warning("%s split produced 0 batches; %s metrics are undefined", split, prefix)
            out = {f"{prefix}/loss": float("nan")}
        else:
            out = {f"{prefix}/loss": float(loss_sum / n)}
        for k, coll in colls.items():
            for name, val in coll.compute(states[k]).items():
                out[name] = float(val)
        return out

    # ------------------------------------------------------------------ #

    def fit(self, seed: int = 0, resume: bool = False) -> FitResult:
        state = self.init_state(seed)
        start_epoch = 0
        if resume and self.ckpt.latest_step() is not None:
            state, step = self.ckpt.restore(state)
            start_epoch = int(step)
            log.info("Resumed from checkpoint at epoch %d", start_epoch)
        result = FitResult(best_val_loss=float("inf"), best_step=-1)
        self._live_state = state
        self._host_snapshot = None
        self._host_snapshot_t = 0.0
        try:
            return self._fit_epochs(state, start_epoch, self.trainer_config.epochs, result)
        except BaseException as e:
            self._save_emergency(e, start_epoch + len(result.history))
            raise

    def _step_precision(self):
        """TF32 off for an f32 step; a bf16 step leaves it as it is."""
        return true_f32() if self._compute_dtype is None else contextlib.nullcontext()

    def _save_emergency(self, e: BaseException, done: int) -> None:
        """Every epoch is checkpointed already; on any exception escaping
        the fit (crash, OOM, interrupt) also keep the mid-epoch state, so at
        most one batch of progress is lost: the live state first, else the
        host mirror (up to `_SNAPSHOT_INTERVAL_S` stale). Under FSDP reading
        the live state is a collective that the other ranks may never join,
        so there rank 0 writes the mirror and no rank waits on another."""
        if not is_primary():
            return
        if self._fsdp:
            epath = self._save_mirror("sharded under FSDP")
        else:
            try:
                self._live_state.optimizer.zero_grad(set_to_none=True)
                epath = self.ckpt.save_emergency(snapshot(self._live_state))
            except Exception:
                epath = self._save_mirror("unreadable")
                if self._host_snapshot is None:
                    log.exception("emergency checkpoint failed")
        if epath is not None:
            log.warning("%s at epoch %d: emergency state saved to %s; resume with "
                        "checkpoint_path set (latest stepped save: %s)",
                        type(e).__name__, done, epath, self.ckpt.latest_step())
        else:
            log.warning("%s at epoch %d: no emergency snapshot possible; resume from the "
                        "latest stepped save: %s", type(e).__name__, done,
                        self.ckpt.latest_step())

    def _save_mirror(self, why: str):
        """Write the host mirror as the emergency snapshot; its path, or None
        when there is no mirror or the write failed."""
        if self._host_snapshot is None:
            return None
        try:
            path = self.ckpt.save_emergency(self._host_snapshot)
        except Exception:
            log.exception("emergency checkpoint failed")
            return None
        log.warning("the live state was unavailable (%s): the emergency snapshot is the host "
                    "mirror of step %d, %.1f s stale (at most %.0f s)", why,
                    self._host_snapshot["step"], time.time() - self._host_snapshot_t,
                    _SNAPSHOT_INTERVAL_S)
        return path

    def _refresh_mirror(self, state) -> None:
        """Take the host mirror when `_SNAPSHOT_INTERVAL_S` has passed since
        the last one. Under FSDP taking it is a collective, so rank 0's clock
        decides for every rank, broadcast as one small tensor per step, and
        rank 0 keeps the gathered copy."""
        now = time.time()
        due = now - self._host_snapshot_t >= _SNAPSHOT_INTERVAL_S
        if self._fsdp:
            flag = torch.tensor([int(due)], device=self.device)
            dist.broadcast(flag, src=0, group=self.group)
            due = bool(flag.item())
        if due:
            mirror = snapshot(state)
            if is_primary() or not self._fsdp:
                self._host_snapshot = mirror
            self._host_snapshot_t = now

    def _fit_epochs(self, state, start_epoch, epochs, result) -> FitResult:
        # early-stopping state (restarts on resume: the best checkpoint on
        # disk is the durable part of the decision)
        es_best, es_bad = float("inf"), 0
        input_metrics_pending = True
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            train_losses = []
            acc, n_acc = None, 0
            for batch in self.dm.loader("train", epoch=epoch, rank=self.rank,
                                        world_size=self.world):
                with self._step_precision():
                    if self._accum > 1:
                        acc = accum_add(acc, self._grad_step(state, batch))
                        n_acc += 1
                        if n_acc < self._accum:
                            continue
                        state, loss = self._apply_step(state, *acc)
                        acc, n_acc = None, 0
                    else:
                        state, loss = self._train_step(state, batch)
                train_losses.append(loss.detach())
                if self.step_callback is not None:
                    self.step_callback()
                self._refresh_mirror(state)
            if acc is not None:
                # a tail shorter than accumulate_grad_batches still steps
                # (Lightning's semantics: no gradient is dropped)
                with self._step_precision():
                    state, loss = self._apply_step(state, *acc)
                train_losses.append(loss.detach())
                if self.step_callback is not None:
                    self.step_callback()
            train_loss = (float(torch.stack(train_losses).mean()) if train_losses
                          else float("nan"))

            val_logs = self._run_eval(state, "val", "val",
                                      include_input_metrics=input_metrics_pending)
            input_metrics_pending = False  # one-shot (the reference's model.py:132-142)
            if self.image_logger is not None and self.image_logger.should_log(epoch):
                self._log_images(state, epoch)
            val_loss = val_logs["val/loss"]
            self.ckpt.save(epoch + 1, state, val_loss)
            if val_loss < result.best_val_loss:
                result.best_val_loss = val_loss
                result.best_step = epoch + 1

            entry = {"epoch": epoch, "train/loss": train_loss, **val_logs,
                     "time_s": time.time() - t0}
            if self.epoch_callback is not None:
                extra = self.epoch_callback(epoch, state)
                if extra:
                    entry.update(extra)
            result.history.append(entry)
            if is_primary():
                self._append_history(entry)
            log.info("epoch %d: train/loss=%.5f val/loss=%.5f (%.1fs)",
                     epoch, train_loss, val_loss, entry["time_s"])

            # Lightning's EarlyStopping on val/loss: an epoch improves when it
            # beats the best by more than min_delta; `patience` epochs
            # without improvement stop the fit
            patience = self.trainer_config.early_stopping_patience
            if patience:
                min_delta = self.trainer_config.early_stopping_min_delta
                if val_loss < es_best - min_delta:
                    es_best, es_bad = val_loss, 0
                else:
                    es_bad += 1
                    if es_bad >= patience:
                        log.info("early stopping at epoch %d: val/loss has not improved by >%g "
                                 "for %d epoch(s) (best %.5f)", epoch, min_delta, patience,
                                 es_best)
                        break
        return result

    def _log_images(self, state: TrainState, epoch: int) -> None:
        """The display batch through the forward on every rank (under FSDP
        the forward is a collective), written by rank 0."""
        db = self._display.prepared_batch()
        with torch.no_grad(), true_f32():
            preds = self._apply(state.module, torch.from_numpy(db["lr"]).to(self.device))
        if is_primary():
            self.image_logger.log_batch(epoch, db["lr"], preds.float().cpu().numpy(), db["hr"])

    def _append_history(self, entry) -> None:
        """One JSON line per epoch in `<run>/history.jsonl`, and each float
        as a TensorBoard scalar at step=epoch under `<run>/tb/`."""
        clean = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in entry.items()}
        with open(self.ckpt.root / "history.jsonl", "a") as f:
            f.write(json.dumps(clean) + "\n")
        try:
            if self._tb is None:
                from ..utils.tbevents import TBEventWriter

                self._tb = TBEventWriter(self.ckpt.root / "tb")
            self._tb.add_scalars({k: v for k, v in clean.items()
                                  if isinstance(v, float) and k != "epoch"},
                                 step=int(entry.get("epoch", 0)))
        except OSError as e:  # observability must never kill a fit
            log.warning("tb event write failed: %s", e)

    def test(
        self,
        state: Optional[TrainState] = None,
        from_best: bool = True,
        extended: bool = True,
        split: str = "test",
    ) -> Dict[str, float]:
        """Evaluate the best (or latest, or given) state on `split`."""
        if state is None:
            state = self.init_state()
            state, _ = (self.ckpt.restore_best(state) if from_best
                        else self.ckpt.restore(state))
        return self._run_eval(state, split, "test", extended=extended)
