"""Train and eval steps: the port of the JAX package's `train/steps.py`.

JAX builds jitted `shard_map` steps over a mesh (its data axis) or a GSPMD
step over a sharded state (its fsdp axis). Here a step is a plain function
of a batch on its device; `group` (a `torch.distributed` process group,
None for one process) is where sums are all-reduced, and the gradients are
reduced by the module's own wrapping: DDP, or FSDP2 (`parallel/sharding.py`).

* `Tx` is the optimizer of `optax.adam(lr, b1, b2)` (chained after
  `optax.clip_by_global_norm(clip)` when clip > 0): `torch.optim.Adam(lr,
  betas, eps=1e-8)`, and `clip_by_global_norm_` in optax's form, which the
  step applies before Adam.
* `TrainState` holds what JAX's holds (step, params, optimizer state): the
  module whose parameters are trained, its optimizer and the step count.
  The steps update it in place and return it.
* `make_train_step`, `make_accum_steps` + `accum_add`, and
  `make_fsdp_train_step` keep JAX's names and semantics: the update is the
  weighted mean of per-sample gradients over the GLOBAL batch, Σ w_i ∂l_i /
  Σ w_i, so padded rows (w = 0) contribute nothing and the update does not
  depend on B % world_size. JAX differentiates the rank's weighted sum (its
  autodiff psums it over the shards) and divides by the psum'd weight sum;
  DDP and FSDP2 AVERAGE the gradients over the ranks, so each rank
  differentiates world_size x its weighted sum, and the step divides the
  reduced gradients once by the all-reduced weight sum. (Averaging, not a
  summing hook: a gradient already reduced by an earlier micro-batch is the
  same on every rank, so averaging it again leaves it as it is, which keeps
  accumulation exact.)
* `compute_dtype=torch.bfloat16` is JAX's mixed precision: the input is
  cast to bf16 and the model casts each parameter to its input's dtype
  inside the forward (`models/rrdb.py`), so every op of the forward runs in
  bf16, while the master parameters, the loss, the gradients and Adam stay
  f32. (Not `torch.autocast`, which keeps elementwise ops in f32 and rounds
  otherwise than JAX.)
* `make_eval_step` and `clamped_apply` (the trainer's forward, from JAX's
  `train/loop.py`) evaluate.

Batches are dicts {"lr": (B,H,W,C), "hr": (B,H',W',C), "weight": (B,)}, as
`data/datamodule.py: XmmDataModule.loader` yields them (`weight` 0 marks a
padded row). `apply_fn(module, x)` is the forward of `module` (the model,
or its DDP or FSDP wrapping): `clamped_apply`, or
`ops/s2d_forward.py: make_s2d_train_apply(model)`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops.preprocess import upsample_nearest

Tensor = torch.Tensor
Batch = Dict[str, Tensor]


def clamped_apply(model, x: Tensor) -> Tensor:
    """forward = clamp(model(x), 0, 1) (the reference's model.py:48-49)."""
    return torch.clamp(model(x), 0.0, 1.0)


def _all_reduce(t: Tensor, group) -> Tensor:
    import torch.distributed as dist

    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def _map2(fn, a, b):
    """fn over the matching leaves of two nested dicts/tuples of tensors."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def make_eval_step(
    model_apply: Callable[[Tensor], Tensor],
    loss_fn: Callable[[Tensor, Tensor], Tensor],
    metric_updaters: Optional[Dict[str, Callable]] = None,
    upsample_input: int = 1,
    group=None,
):
    """Build `eval_step(states, batch) -> (states, loss_sum_delta,
    weight_sum_delta)`.

    `model_apply(x)` is the forward (`clamped_apply` of a model, say).
    `metric_updaters` maps state key -> update(state, preds_or_lr, target, w,
    group), a collection's `update`: mean-style metrics normalize over the
    group (`metrics.collection.batch_mean_delta`). A key that starts with
    "in:" receives the input, upsampled nearest by `upsample_input`, in
    place of the prediction: the reference's input-baseline metrics (its
    model.py:90-105). Per-sample losses are weighted by `w`, so padded rows
    (w = 0) contribute nothing and val/loss does not depend on the padding.
    """
    metric_updaters = metric_updaters or {}

    @torch.no_grad()
    def eval_step(states, batch: Dict[str, Tensor]):
        lr, target = batch["lr"], batch["hr"]
        w = batch.get("weight")
        if w is None:
            w = torch.ones((lr.shape[0],), dtype=torch.float32, device=lr.device)
        preds = model_apply(lr)
        per_sample = torch.stack(
            [loss_fn(preds[i : i + 1], target[i : i + 1]) for i in range(preds.shape[0])]
        )
        loss_delta = torch.sum(per_sample * w)
        n_delta = torch.sum(w)
        if group is not None:
            loss_delta, n_delta = _all_reduce(loss_delta, group), _all_reduce(n_delta, group)

        lr_up = lr
        if upsample_input != 1:
            lr_up = upsample_nearest(lr.permute(0, 3, 1, 2), upsample_input).permute(0, 2, 3, 1)

        new_states = {}
        for key, update in metric_updaters.items():
            src = lr_up if key.startswith("in:") else preds
            st = states[key]
            new = update(st, src, target, w, group)
            if group is not None:  # all-reduce the delta, so every rank holds the same state
                new = _map2(lambda a, b: a + _all_reduce(b - a, group), st, new)
            new_states[key] = new
        return new_states, loss_delta, n_delta

    return eval_step


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------


class Tx(NamedTuple):
    """The optimizer: `optax.adam(learning_rate, b1, b2)`, after
    `optax.clip_by_global_norm(clip)` when clip > 0."""

    learning_rate: float
    betas: Tuple[float, float] = (0.9, 0.999)
    clip: float = 0.0

    def init(self, params) -> torch.optim.Adam:
        """Adam over `params` with optax's eps (1e-8, outside the root)."""
        return torch.optim.Adam(params, lr=self.learning_rate, betas=tuple(self.betas), eps=1e-8)


@dataclass
class TrainState:
    """The module being trained (the model, or its DDP or FSDP wrapping),
    its optimizer, and the count of optimizer steps taken."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, module: nn.Module, tx: Tx) -> "TrainState":
        return cls(module, tx.init(module.parameters()))


def _full(t: Tensor) -> Tensor:
    """A full tensor from a DTensor (an FSDP-sharded reduction), else `t`."""
    full = getattr(t, "full_tensor", None)
    return full() if full is not None else t


def global_norm(grads) -> Tensor:
    """optax's `global_norm`: sqrt of the sum over leaves of sum(g^2), in
    f32, over the whole model (an FSDP-sharded gradient counts all its
    shards)."""
    total = None
    for g in grads:
        s = torch.sum(torch.square(g))
        total = s if total is None else total + s
    return torch.sqrt(_full(total))


def clip_by_global_norm_(grads, max_norm: float) -> Tensor:
    """optax's `clip_by_global_norm`, in place: every gradient is left as
    it is when the global norm is below `max_norm`, and is otherwise
    (g / norm) * max_norm. (Not `torch.nn.utils.clip_grad_norm_`, which
    scales by max_norm / (norm + 1e-6).) Returns the norm."""
    grads = list(grads)
    norm = global_norm(grads)
    if not bool(norm < max_norm):
        n = float(norm)
        for g in grads:
            g.div_(n).mul_(max_norm)
    return norm


def _weights(batch: Batch) -> Tensor:
    w = batch.get("weight")
    if w is None:
        w = torch.ones((batch["lr"].shape[0],), dtype=torch.float32, device=batch["lr"].device)
    return w


def _loss_sum(apply_fn, loss_fn, module, batch: Batch, w: Tensor, compute_dtype) -> Tensor:
    """Σ_i w_i loss_i over the rank's rows, the loss in f32."""
    x = batch["lr"] if compute_dtype is None else batch["lr"].to(compute_dtype)
    preds = apply_fn(module, x).float()
    hr = batch["hr"]
    per_sample = torch.stack([loss_fn(preds[i : i + 1], hr[i : i + 1]) for i in range(preds.shape[0])])
    return torch.sum(per_sample * w)


def make_accum_steps(
    apply_fn: Callable[[nn.Module, Tensor], Tensor],
    loss_fn: Callable[[Tensor, Tensor], Tensor],
    tx: Tx,
    group=None,
    compute_dtype: Optional[torch.dtype] = None,
):
    """(grad_step, apply_step) for gradient accumulation (Lightning's
    `accumulate_grad_batches`), exact with respect to one big batch.

      grad_step(state, batch) -> (loss_sum, weight_sum)
          adds d/dp Σ_i w_i loss_i over the global batch to the parameters'
          `.grad` and returns the global sums Σ w_i loss_i and Σ w_i;
      apply_step(state, loss_sum, weight_sum) -> (state, mean_loss)
          divides the gradients by `weight_sum`, clips (`tx.clip`), takes
          the Adam step and clears the gradients.

    JAX's grad_step returns the gradient sum as a pytree; here it stays in
    `.grad`, where backward accumulates it. `group` is the process group the
    module's gradients are averaged over (DDP or FSDP), None for one
    process."""
    world = 1
    if group is not None:
        import torch.distributed as dist

        world = dist.get_world_size(group)

    def grad_step(state: TrainState, batch: Batch):
        w = _weights(batch)
        lsum = _loss_sum(apply_fn, loss_fn, state.module, batch, w, compute_dtype)
        (lsum * world if world > 1 else lsum).backward()
        lsum, wsum = lsum.detach(), torch.sum(w)
        if group is not None:
            lsum, wsum = _all_reduce(lsum, group), _all_reduce(wsum, group)
        return lsum, wsum

    def apply_step(state: TrainState, loss_sum: Tensor, weight_sum: Tensor):
        params = [p for p in state.module.parameters() if p.grad is not None]
        d = float(weight_sum)
        for p in params:
            p.grad.div_(d)
        if tx.clip > 0.0:
            clip_by_global_norm_([p.grad for p in params], tx.clip)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, loss_sum / weight_sum

    return grad_step, apply_step


def accum_add(acc, delta):
    """Accumulate (loss_sum, weight_sum) pairs; `acc` None starts a group."""
    if acc is None:
        return delta
    return tuple(a + d for a, d in zip(acc, delta))


def make_train_step(
    apply_fn: Callable[[nn.Module, Tensor], Tensor],
    loss_fn: Callable[[Tensor, Tensor], Tensor],
    tx: Tx,
    group=None,
    compute_dtype: Optional[torch.dtype] = None,
):
    """`train_step(state, batch) -> (state, loss)`: one optimizer step on
    the weighted mean loss of the global batch (`make_accum_steps`' two
    halves on one batch). Under DDP `state.module` is the DDP module and
    `group` its process group."""
    grad_step, apply_step = make_accum_steps(apply_fn, loss_fn, tx, group, compute_dtype)

    def train_step(state: TrainState, batch: Batch):
        return apply_step(state, *grad_step(state, batch))

    return train_step


def make_fsdp_train_step(
    apply_fn: Callable[[nn.Module, Tensor], Tensor],
    loss_fn: Callable[[Tensor, Tensor], Tensor],
    tx: Tx,
    group=None,
    compute_dtype: Optional[torch.dtype] = None,
):
    """The train step of an FSDP2-sharded module (JAX's GSPMD step over
    fsdp-sharded params): the same step as `make_train_step`. FSDP2
    all-gathers the parameters around each sharded module, reduce-scatters
    the averaged gradients into the shards, the clip's norm covers every
    shard (`global_norm`), and Adam steps the local shards."""
    return make_train_step(apply_fn, loss_fn, tx, group, compute_dtype)
