"""Data module: dataset + splits + host-prefetched batches prepared on the device.

The port of the JAX package's `data/datamodule.py`, which replaces the
reference's Lightning DataModule + torch DataLoader stack:

  * host side: index shuffling, FITS decode + composite in a prefetch
    thread (the stand-in for the reference's 12 DataLoader workers), into
    pinned memory when the device is a card;
  * device side: one prepare per batch on the module's device (mask ->
    pad -> clamp/stretch, HR upsampled for REAL data), `prepare_batch`.

Data parallelism without a mesh: `loader(split, rank=r, world_size=n)` pads
each global batch to a multiple of `n` (the last sample repeated, weight 0
on the padded rows, as the JAX package's `pad_batch_to_devices` pads) and
yields rank `r`'s contiguous share of it, so the union over ranks is the JAX
loader's global batch. Every rank decodes the whole global batch: the
composites draw AGN and background files from the dataset's one RNG in
sample order, and every rank must draw the same sequence.

Split layout matches the reference (`res/splits/...`, sim 0.8/0.1/0.1 of
base names, real 0.7/0.15/0.15 per exposure) with the corrected offset-based
index expansion (`splits.expand_indices`).
"""

from __future__ import annotations

import queue
import threading
import zlib
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config.schema import DatasetCfg, DatasetType
from ..ops.preprocess import pad_to_res, upsample_nearest
from ..ops.stretch import Normalizer, normalize
from .datasets import BoringDataset, XmmDataset, load_det_mask
from .splits import REAL_FRACTIONS, SIM_FRACTIONS, ensure_splits, expand_indices, random_split_indices

Tensor = torch.Tensor
Batch = Dict[str, Tensor]


def pad_batch(batch: Dict[str, np.ndarray], n: int) -> Tuple[Dict[str, np.ndarray], int]:
    """Pad a host batch so B % n == 0 by repeating its last sample; returns
    (padded batch, count of real samples)."""
    b = next(iter(batch.values())).shape[0]
    if b % n == 0:
        return batch, b
    pad = n - b % n
    return {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)]) for k, v in batch.items()}, b


def make_prep(
    cfg: DatasetCfg,
    lr_mask: Optional[np.ndarray],
    hr_mask: Optional[np.ndarray],
    hr_scale: int,
    device,
) -> Callable[[Tensor, Optional[Tensor]], Tuple[Tensor, Optional[Tensor]]]:
    """prep(lr_raw, hr_raw) on NHWC tensors on `device`: mask -> pad_to_res
    -> normalize for LR; mask -> (nearest upsample by `hr_scale`) ->
    pad_to_res -> normalize for HR. Boring data is already at model
    resolution and passes through (the reference feeds it straight on)."""
    if cfg.type is DatasetType.BORING:
        return lambda lr_raw, hr_raw: (lr_raw, hr_raw)
    lr_m = None if lr_mask is None else torch.from_numpy(lr_mask).to(device)[..., None]
    hr_m = None if hr_mask is None else torch.from_numpy(hr_mask).to(device)[..., None]
    mode = cfg.scaling

    def prep(lr_raw: Tensor, hr_raw: Optional[Tensor]):
        lr = lr_raw if lr_m is None else lr_raw * lr_m
        lr = pad_to_res(lr.permute(0, 3, 1, 2), cfg.lr.res).permute(0, 2, 3, 1)
        lr = normalize(lr, cfg.lr.clamp_max, mode).contiguous()
        hr = None
        if hr_raw is not None:
            hr = hr_raw if hr_m is None else hr_raw * hr_m
            hr = hr.permute(0, 3, 1, 2)
            if hr_scale != 1:
                hr = upsample_nearest(hr, hr_scale)
            hr = pad_to_res(hr, cfg.hr.res).permute(0, 2, 3, 1)
            hr = normalize(hr, cfg.hr.clamp_max, mode).contiguous()
        return lr, hr

    return prep


class XmmDataModule:
    def __init__(
        self,
        config: DatasetCfg,
        splits_root: Path = Path("res/splits"),
        seed: int = 0,
        prefetch: int = 2,
        boring_size: int = 10000,
        device="cuda:0",
    ):
        self.config = config
        self.seed = seed
        self.prefetch = prefetch
        self.device = torch.device(device)
        self.normalizer = Normalizer(
            lr_max=config.lr.clamp_max,
            hr_max=config.hr.clamp_max if config.hr else config.lr.clamp_max,
            mode=config.scaling,
        )

        self.lr_mask = load_det_mask(config.lr.det_mask)
        self.hr_mask = load_det_mask(config.hr.det_mask) if config.hr else None

        if config.type is DatasetType.BORING:
            self.dataset = BoringDataset(
                lr_exps=list(config.lr.exps),
                hr_exp=config.hr.exp if config.hr else 100,
                hr_res_mult=config.res_mult,
                lr_res=config.lr.res,
                dataset_size=boring_size,
                seed=seed,
            )
            self._splits = random_split_indices(len(self.dataset), SIM_FRACTIONS, seed)
        else:
            self.dataset = XmmDataset(
                config, comb_hr_img=config.comb_hr, rng=np.random.default_rng(seed)
            )
            n_base = self.dataset.catalog.base_name_count
            fracs = SIM_FRACTIONS if config.type is DatasetType.SIM else REAL_FRACTIONS
            leaf = (
                f"{config.mode}.p"
                if config.type is DatasetType.SIM
                else f"{config.lr.exps[0]}ks.p"
            )
            base_splits = ensure_splits(Path(splits_root) / config.name, leaf, n_base, fracs, seed)
            mult = len(self.dataset) // n_base
            self._splits = {
                name: expand_indices(idx, n_base, mult) for name, idx in base_splits.items()
            }

        hr_scale = self.dataset.upsample_scale if config.type is DatasetType.REAL else 1
        self._prep = make_prep(config, self.lr_mask, self.hr_mask, hr_scale, self.device)

    # ------------------------------------------------------------------ #

    def split_indices(self, split: str) -> np.ndarray:
        return self._splits[split]

    def prepare_batch(self, host: Dict[str, np.ndarray]) -> Tuple[Tensor, Optional[Tensor]]:
        """A raw NHWC host batch {"lr"[, "hr"]} prepared on the device:
        (lr, hr or None), normalized and padded to model resolution."""
        dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device) for k, v in host.items()}
        return self._prep(dev["lr"], dev.get("hr"))

    def _host_batches(
        self, split: str, batch_size: int, shuffle: bool, rng: np.random.Generator
    ) -> Iterator[Dict[str, np.ndarray]]:
        indices = np.array(self._splits[split])
        if shuffle:
            rng.shuffle(indices)
        for start in range(0, len(indices), batch_size):
            chunk = indices[start : start + batch_size]
            lrs, hrs = [], []
            for i in chunk:
                lr, hr = self.dataset[int(i)]
                lrs.append(lr.transpose(1, 2, 0))  # CHW -> HWC
                if hr is not None:
                    hrs.append(hr.transpose(1, 2, 0))
            batch = {"lr": np.stack(lrs)}
            if hrs:
                batch["hr"] = np.stack(hrs)
            yield batch

    def _share(self, hb: Dict[str, np.ndarray], rank: int, world_size: int):
        """Rank `rank`'s contiguous share of the padded global batch, with
        its weights (1 for real samples, 0 for the padding)."""
        hb, valid = pad_batch(hb, world_size)
        b = hb["lr"].shape[0]
        per = b // world_size
        rows = slice(rank * per, (rank + 1) * per)
        share = {k: v[rows] for k, v in hb.items()}
        share["weight"] = (np.arange(b) < valid).astype(np.float32)[rows]
        return share

    def loader(
        self,
        split: str,
        batch_size: Optional[int] = None,
        shuffle: Optional[bool] = None,
        epoch: int = 0,
        rank: int = 0,
        world_size: int = 1,
    ) -> Iterator[Batch]:
        """Yield batches prepared on the device: {"lr", "hr", "weight"} NHWC,
        normalized, rank `rank`'s share of each global batch, with threaded
        host prefetch ("hr" is "lr" for a dataset without an HR side). An
        exception of the host side (a file that cannot be read) is raised
        here, not swallowed with the rest of the epoch."""
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside world size {world_size}")
        batch_size = batch_size or self.config.batch_size
        if shuffle is None:
            shuffle = split == "train"
        # not hash(split): str hashes are salted per interpreter run
        # (PYTHONHASHSEED), which would make the shuffle irreproducible and
        # give each process of a multi-process run a different permutation
        split_token = zlib.crc32(split.encode("utf-8")) & 0xFFFF
        rng = np.random.default_rng((self.seed, epoch, split_token))

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        abandoned = threading.Event()
        failure = []  # the producer's exception, raised again in the consumer
        pin = self.device.type == "cuda"

        def producer():
            try:
                for hb in self._host_batches(split, batch_size, shuffle, rng):
                    share = {k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in self._share(hb, rank, world_size).items()}
                    if pin:
                        share = {k: v.pin_memory() for k, v in share.items()}
                    # bounded put + shutdown flag: if the consumer abandons
                    # the generator mid-epoch (an exception in the step), a
                    # plain q.put would park this thread forever on the full
                    # queue, holding `prefetch` decoded batches
                    while not abandoned.is_set():
                        try:
                            q.put(share, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if abandoned.is_set():
                        return
            except BaseException as e:  # noqa: BLE001  (handed to the consumer)
                failure.append(e)
            finally:
                while not abandoned.is_set():
                    try:
                        q.put(sentinel, timeout=0.5)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                share = q.get()
                if share is sentinel:
                    if failure:
                        raise failure[0]
                    break
                dev = {k: v.to(self.device, non_blocking=pin) for k, v in share.items()}
                lr, hr = self._prep(dev["lr"], dev.get("hr"))
                yield {"lr": lr, "hr": hr if hr is not None else lr, "weight": dev["weight"]}
        finally:
            abandoned.set()
