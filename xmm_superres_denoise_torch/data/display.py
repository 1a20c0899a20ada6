"""Display data module: a fixed curated batch for epoch image logging.

The port of the JAX package's `data/display.py`. The reference's
`XmmDisplayDataModule` is broken in its tree (it imports a removed
`XmmSimDataset`); this is the working rebuild: a deterministic, fixed
selection of validation samples rendered identically every epoch so panels
are comparable across training.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .datamodule import XmmDataModule


class XmmDisplayDataModule:
    """Wraps a parent datamodule and pins a fixed display batch."""

    def __init__(
        self,
        datamodule: XmmDataModule,
        split: str = "val",
        num_images: int = 4,
        indices: Optional[List[int]] = None,
    ):
        self.dm = datamodule
        if indices is None:
            pool = datamodule.split_indices(split)
            indices = list(map(int, pool[:num_images]))
        self.indices = indices

    _cached: Optional[Dict[str, np.ndarray]] = None

    def display_batch(self) -> Dict[str, np.ndarray]:
        """Raw host batch of the pinned samples, NHWC (un-normalized for raw
        geometry datasets; `prepared_batch` runs the datamodule's prep).

        Loaded once and cached: XmmDataset composites draw random AGN and
        background picks from the dataset's shared RNG, so re-sampling per
        epoch would both render different composites (panels would not be
        comparable across training) and perturb the training sample
        sequence. The one-time load uses a private RNG for the same reason."""
        if self._cached is not None:
            return self._cached
        ds_rng = getattr(self.dm.dataset, "rng", None)
        if ds_rng is not None:
            self.dm.dataset.rng = np.random.default_rng(1234)
        try:
            lrs, hrs = [], []
            for i in self.indices:
                lr, hr = self.dm.dataset[int(i)]
                lrs.append(lr.transpose(1, 2, 0))
                if hr is not None:
                    hrs.append(hr.transpose(1, 2, 0))
        finally:
            if ds_rng is not None:
                self.dm.dataset.rng = ds_rng
        out = {"lr": np.stack(lrs)}
        if hrs:
            out["hr"] = np.stack(hrs)
        self._cached = out
        return out

    def prepared_batch(self) -> Dict[str, Optional[np.ndarray]]:
        """The display batch prepared (normalized, padded) on the
        datamodule's device, returned as host arrays."""
        lr, hr = self.dm.prepare_batch(self.display_batch())
        return {"lr": lr.cpu().numpy(), "hr": None if hr is None else hr.cpu().numpy()}
