"""Accumulating metric collections with explicit (sum, count) state.

The port of the JAX package's `metrics/collection.py`, which replaces
torchmetrics' stateful Metric objects (the reference's `metrics/metrics.py`
and `xmm_metric_collection.py:114-143`) with an explicit state:

  * `init(device, dtype) -> state`, `update(state, preds, target, weights,
    group) -> state` (tensors on the device, no host round trip),
    `compute(state) -> {name: 0-d tensor}`;
  * state is `{name: (sum, count)}`, 0-d tensors of the inputs' dtype on
    their device (f32 when evaluating).

Accumulation semantics mirror each torchmetrics reduction:
  psnr      : (sum_squared_error, n_elements)       -> 10*log10(r^2/(sse/n))
  ssim      : (sum of per-image ssim, n_images)
  ms_ssim   : (sum of per-image ms-ssim, n_images)
  l1/l2     : (sum of abs/sq error, n_elements)
  poisson   : (sum of batch means, n_IMAGES): the reference's custom
              `_Metric` accumulates one batch-mean per batch but divides by
              the total image count, reproduced as-is (its metrics.py:30-39).

Data parallelism: `group` is an optional `torch.distributed` process group,
the counterpart of the JAX package's `axis_name`. The eval step
(`train/steps.py`) all-reduces state deltas over it, which is exactly right
for sum-style states but would add one shard-mean per rank for mean-style
ones (poisson and the extended suite). Updaters therefore take the group:
when set, the mean is taken over the global batch (all-reduced numerator and
denominator) and pre-divided by the group's size, so the delta all-reduce
reconstructs one global batch-mean. With `group=None` (one process) nothing
is reduced.

`XMMMetricCollection`: before each update, preds/target are de-stretched
with the dataset normalizer's bare destretch and re-stretched per scaling
normalizer (the reference's xmm_metric_collection.py:135-143); metrics are
named `{prefix}/{stretch}/{metric}` (`{prefix}/{stretch}/in/{metric}` for the
input baseline).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..ops.ssim import ms_ssim_per_image, ssim_per_image
from ..ops.stretch import Normalizer

Tensor = torch.Tensor
State = Dict[str, Tuple[Tensor, Tensor]]

CORE_METRIC_NAMES = ("psnr", "ssim", "ms_ssim", "l1", "l2", "poisson")


def _per_image_sum(x: Tensor) -> Tensor:
    return torch.sum(x.reshape(x.shape[0], -1), dim=-1)


def _elements_per_image(p: Tensor) -> float:
    return p.numel() / p.shape[0]


def _upd_psnr(p: Tensor, t: Tensor, w: Tensor, group=None) -> Tuple[Tensor, Tensor]:
    per_img = _per_image_sum(torch.square(p - t))
    return torch.sum(w * per_img), torch.sum(w) * _elements_per_image(p)


def _upd_ssim(p: Tensor, t: Tensor, w: Tensor, group=None) -> Tuple[Tensor, Tensor]:
    return torch.sum(w * ssim_per_image(p, t)), torch.sum(w)


def _upd_ms_ssim(p: Tensor, t: Tensor, w: Tensor, group=None) -> Tuple[Tensor, Tensor]:
    return torch.sum(w * ms_ssim_per_image(p, t)), torch.sum(w)


def _upd_l1(p: Tensor, t: Tensor, w: Tensor, group=None) -> Tuple[Tensor, Tensor]:
    per_img = _per_image_sum(torch.abs(p - t))
    return torch.sum(w * per_img), torch.sum(w) * _elements_per_image(p)


def _upd_l2(p: Tensor, t: Tensor, w: Tensor, group=None) -> Tuple[Tensor, Tensor]:
    per_img = _per_image_sum(torch.square(p - t))
    return torch.sum(w * per_img), torch.sum(w) * _elements_per_image(p)


def batch_mean_delta(per_img: Tensor, w: Tensor, group=None) -> Tensor:
    """One global weighted batch-mean per update, robust to data parallelism.

    Without `group`: the local weighted mean. With it: numerator and
    denominator are all-reduced so every rank sees the global batch mean,
    then pre-divided by the group's size because the eval step all-reduces
    state deltas: the sum of `mean / world_size` over ranks is one global
    batch-mean, whatever the number of ranks."""
    num = torch.sum(w * per_img)
    den = torch.sum(w)
    if group is not None:
        import torch.distributed as dist

        both = torch.stack([num, den])
        dist.all_reduce(both, group=group)
        return both[0] / torch.clamp(both[1], min=1.0) / dist.get_world_size(group)
    return num / torch.clamp(den, min=1.0)


def _upd_poisson(p: Tensor, t: Tensor, w: Tensor, group=None) -> Tuple[Tensor, Tensor]:
    per_img = torch.mean((p - t * torch.log(p + 1e-8)).reshape(p.shape[0], -1), dim=-1)
    # the reference accumulates batch means / total image count (its
    # metrics.py:30-39); the weighted per-image form reduces to that for
    # full batches
    return batch_mean_delta(per_img, w, group), torch.sum(w)


_UPDATES: Dict[str, Callable[..., Tuple[Tensor, Tensor]]] = {
    "psnr": _upd_psnr,
    "ssim": _upd_ssim,
    "ms_ssim": _upd_ms_ssim,
    "l1": _upd_l1,
    "l2": _upd_l2,
    "poisson": _upd_poisson,
}


def _compute_one(name: str, s: Tensor, n: Tensor, data_range: float = 1.0) -> Tensor:
    if name.split("/")[-1] == "psnr":
        return 10.0 * torch.log10(data_range**2 / (s / n))
    return s / n


class MetricBank:
    """A named set of accumulating metrics with explicit state."""

    def __init__(self, names: Sequence[str] = CORE_METRIC_NAMES):
        unknown = [n for n in names if n.split("/")[-1] not in _UPDATES]
        if unknown:
            raise ValueError(f"Unknown metrics: {unknown}")
        self.names = tuple(names)

    def init(self, device="cuda:0", dtype: torch.dtype = torch.float32) -> State:
        z = torch.zeros((), dtype=dtype, device=device)
        return {n: (z, z) for n in self.names}

    def update(
        self,
        state: State,
        preds: Tensor,
        target: Tensor,
        weights: Optional[Tensor] = None,
        group=None,
    ) -> State:
        """Accumulate one batch. `weights` is an optional per-sample (B,)
        weight vector (0 for padded samples); `group` must be set when the
        batch is one rank's share and the state deltas are all-reduced over
        it (module docstring)."""
        if weights is None:
            weights = torch.ones((preds.shape[0],), dtype=preds.dtype, device=preds.device)
        out = {}
        for n in self.names:
            ds, dn = _UPDATES[n.split("/")[-1]](preds, target, weights, group)
            s, c = state[n]
            out[n] = (s + ds, c + dn)
        return out

    def compute(self, state: State) -> Dict[str, Tensor]:
        return {n: _compute_one(n, *state[n]) for n in self.names}


class XMMMetricCollection:
    """Per-stretch-mode metric evaluation (the reference's
    xmm_metric_collection.py:114-143).

    For each scaling normalizer: destretch preds/target with the dataset
    normalizer's inverse stretch, re-stretch with the scaling normalizer's
    stretch, then update a MetricBank of its own. Keys follow the
    reference's `{prefix}/{stretch_mode}/{metric}` layout.
    """

    def __init__(
        self,
        dataset_normalizer: Normalizer,
        scaling_normalizers: Sequence[Normalizer],
        prefix: str,
        metric_names: Sequence[str] = CORE_METRIC_NAMES,
        input_baseline: bool = False,
    ):
        self.dataset_normalizer = dataset_normalizer
        self.scaling_normalizers = list(scaling_normalizers)
        base = "in/" if input_baseline else ""
        self.prefix = prefix
        self.banks = {
            nz.mode: MetricBank([f"{prefix}/{nz.mode}/{base}{m}" for m in metric_names])
            for nz in self.scaling_normalizers
        }

    def init(self, device="cuda:0", dtype: torch.dtype = torch.float32) -> Dict[str, State]:
        return {mode: bank.init(device, dtype) for mode, bank in self.banks.items()}

    def update(
        self,
        state: Dict[str, State],
        preds: Tensor,
        target: Tensor,
        weights: Optional[Tensor] = None,
        group=None,
    ) -> Dict[str, State]:
        preds = self.dataset_normalizer.destretch_only(preds)
        target = self.dataset_normalizer.destretch_only(target)
        out = {}
        for nz in self.scaling_normalizers:
            p = nz.stretch_only(preds)
            t = nz.stretch_only(target)
            out[nz.mode] = self.banks[nz.mode].update(state[nz.mode], p, t, weights, group)
        return out

    def compute(self, state: Dict[str, State]) -> Dict[str, Tensor]:
        out: Dict[str, Tensor] = {}
        for mode, bank in self.banks.items():
            out.update(bank.compute(state[mode]))
        return out
