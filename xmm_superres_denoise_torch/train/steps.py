"""The eval step, and the clamped forward the trainer evaluates.

The port of `make_eval_step` of the JAX package's `train/steps.py` (and of
`clamped_apply` from its `train/loop.py`). JAX builds one jitted
`shard_map` step over the mesh's data axis and psums the state deltas; here
the step is a plain function of the batch on its device, under
`torch.no_grad()`, and `group` (a `torch.distributed` process group, None
for one process) is where the deltas are all-reduced.

Batches are dicts {"lr": (B,H,W,C), "hr": (B,H',W',C), "weight": (B,)}, as
`data/datamodule.py: XmmDataModule.loader` yields them (`weight` 0 marks a
padded row). The train step, gradient accumulation and FSDP come with the
training harness.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..ops.preprocess import upsample_nearest

Tensor = torch.Tensor


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
