"""Dataset sources: simulated composites, real exposure splits, synthetic.

The port of the JAX package's `data/datasets.py` (numpy; copied, not
imported), which rebuilds the reference's `data/dataset.py:24-283`:

  * host side (this module): file selection, FITS decode, additive
    composite (img + AGN + background), returning RAW native-geometry
    float32 arrays;
  * device side (`data/datamodule.py`): mask -> (upsample) -> pad ->
    clamp/stretch normalization per batch, on the module's device.

Index semantics: the reference decomposes a flat index with two aliased `%`
ops (its dataset.py:214-215, a known defect); here the flat index is
decomposed mixed-radix over (base_name, lr_exp) so every (image, exposure)
pair is visited. AGN/background picks stay stochastic per access, drawn
from the dataset's one `np.random.Generator` in the JAX package's order, so
one seed gives the same samples in both packages.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..config.schema import DatasetCfg, DatasetType
from ..io.fits import read_image
from .catalog import SPLIT_KEY_REAL, SPLIT_KEY_SIM, Catalog, build_catalog, find_img_dirs, find_img_files
from .native_loader import load_fits_fast as load_fits

Sample = Tuple[np.ndarray, Optional[np.ndarray]]  # raw (1,H,W) lr, hr


def load_det_mask(path: Optional[Path]) -> Optional[np.ndarray]:
    """A detector mask FITS image as float32, or None for no mask."""
    if path is None:
        return None
    img, _ = read_image(path)
    return np.ascontiguousarray(img, dtype=np.float32)


def check_img(path: Path, shape: Tuple[int, int, int]) -> None:
    """Shape/NaN/range integrity check (data/tools.py:58-76)."""
    img = load_fits(path)
    if img.shape != shape:
        raise ValueError(f"{path}: wrong shape {img.shape}, expected {shape}")
    if np.any(np.isnan(img)):
        raise ValueError(f"{path}: contains NaN")
    if np.any(img > 100000):
        raise ValueError(f"{path}: contains a value bigger than 100000")
    if np.any(img < 0):
        raise ValueError(f"{path}: contains a negative value")


class BoringDataset:
    """Synthetic random pairs at production shapes (dataset.py:52-74).

    The only built-in fixture of the reference; kept as the zero-data path
    that exercises the full train/eval loop. Deterministic per (seed, idx).
    """

    def __init__(
        self,
        lr_exps: Optional[List[int]] = None,
        hr_exp: int = 100,
        hr_res_mult: int = 2,
        dataset_size: int = 10000,
        lr_res: int = 416,
        seed: int = 0,
    ):
        self.lr_exps = lr_exps or [20]
        self.hr_exp = hr_exp
        self.hr_res_mult = hr_res_mult
        self.dataset_size = dataset_size
        self.lr_res = lr_res
        self.seed = seed

    def __len__(self) -> int:
        return self.dataset_size

    def __getitem__(self, idx: int) -> Sample:
        g = np.random.default_rng((self.seed, idx))
        lr = g.standard_normal((1, self.lr_res, self.lr_res), dtype=np.float32)
        hr = g.standard_normal(
            (1, self.lr_res * self.hr_res_mult, self.lr_res * self.hr_res_mult),
            dtype=np.float32,
        )
        return lr, hr

    # Boring samples are already at model resolution and pre-"normalized".
    raw_geometry = False


class XmmDataset:
    """Sim/real XMM dataset over a matched file catalog (dataset.py:77-283).

    ``__getitem__`` returns RAW composites at native detector geometry
    (1, 411, 403)·res_mult — mask/pad/normalize happen on device downstream.
    """

    raw_geometry = True

    def __init__(self, config: DatasetCfg, comb_hr_img: bool = False, rng=None):
        self.config = config
        self.rng = rng or np.random.default_rng(0)
        c = config

        split_key = SPLIT_KEY_SIM if c.type is DatasetType.SIM else SPLIT_KEY_REAL
        lr_res_dir = "1x" if c.type is DatasetType.SIM else ""
        if c.type is DatasetType.REAL and c.hr and c.hr.exp:
            hr_res_dir = ""
        elif c.type is DatasetType.SIM and comb_hr_img:
            hr_res_dir = f"{c.res_mult}x_comb"
        else:
            hr_res_dir = f"{c.res_mult}x"

        hr_exp = c.hr.exp if c.hr is not None else None
        self.catalog: Catalog = build_catalog(
            c.img_dir, c.lr.exps, hr_exp, lr_res_dir, hr_res_dir, split_key
        )

        self.upsample_scale = 1
        if c.type is DatasetType.REAL and c.hr is not None and c.hr.res != c.lr.res:
            self.upsample_scale = c.res_mult

        if c.check_files:
            native = (1, 411, 403)
            for exp in c.lr.exps:
                for b in range(self.catalog.base_name_count):
                    for p in self.catalog.lr_files(exp, b):
                        check_img(p, native)
            if self.catalog.hr is not None:
                m = c.res_mult
                for b in range(self.catalog.base_name_count):
                    for p in self.catalog.hr_files(hr_exp, b):
                        check_img(p, (1, 411 * m, 403 * m))

        # --- AGN catalog (sim only) --- #
        self.agn_catalog: Optional[Catalog] = None
        self.agn_mult = int(c.agn)
        if self.agn_mult > 0 and c.type is not DatasetType.REAL:
            self.agn_catalog = build_catalog(
                c.agn_dir, c.lr.exps, hr_exp, lr_res_dir, hr_res_dir, split_key
            )

        # --- Background files (sim only) --- #
        self.bkg_files = None
        self.bkg_mult = int(c.lr.bkg)
        if self.bkg_mult > 0 and c.type is not DatasetType.REAL:
            bkg_dirs = find_img_dirs(c.bkg_dir, c.lr.exps, lr_res_dir)
            files = find_img_files(bkg_dirs)
            amt = min(len(v) for v in files.values())
            # Equal-size per-exposure background pools (dataset.py:193-196);
            # deterministic choice instead of random.sample for reproducibility.
            self.bkg_files = {
                exp: sorted(v)[:amt] for exp, v in files.items()
            }

        self.dataset_size = (
            self.catalog.base_name_count
            * len(c.lr.exps)
            * max(self.agn_mult, 1)
            * max(self.bkg_mult, 1)
        )

    def __len__(self) -> int:
        return self.dataset_size

    def decompose_index(self, idx: int) -> Tuple[int, int]:
        """Mixed-radix (base_name, lr_exp) decomposition — fixes the aliasing
        defect at reference dataset.py:214-215."""
        n_base = self.catalog.base_name_count
        base = idx % n_base
        exp_i = (idx // n_base) % len(self.config.lr.exps)
        return base, exp_i

    def _pick(self, files: List[Path]) -> Path:
        return files[int(self.rng.integers(len(files)))]

    def load_sample(self, idx: int) -> Sample:
        c = self.config
        base, exp_i = self.decompose_index(idx)
        lr_exp = c.lr.exps[exp_i]
        hr_exp = c.hr.exp if c.hr is not None else None

        lr = load_fits(self._pick(self.catalog.lr_files(lr_exp, base)))

        hr = None
        if self.catalog.hr is not None:
            hr = load_fits(self._pick(self.catalog.hr_files(hr_exp, base)))

        if self.agn_catalog is not None:
            agn_idx = int(self.rng.integers(self.agn_catalog.base_name_count))
            lr = lr + load_fits(self._pick(self.agn_catalog.lr_files(lr_exp, agn_idx)))
            if hr is not None:
                hr = hr + load_fits(
                    self._pick(self.agn_catalog.hr_files(hr_exp, agn_idx))
                )

        if self.bkg_files is not None:
            lr = lr + load_fits(self._pick(self.bkg_files[lr_exp]))

        return lr, hr

    def __getitem__(self, idx: int) -> Sample:
        return self.load_sample(idx)
