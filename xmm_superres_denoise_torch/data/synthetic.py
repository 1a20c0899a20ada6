"""A synthetic simulated dataset on disk, in the layout the catalog reads.

There is no public XMM simulation set to ship with the repo, so smoke runs
and tests write one: seeded Poisson images (a flat background with a few
point sources) as count rates, float32 FITS through the port's codec, laid
out as `data/catalog.py: find_img_dirs` expects:

    <directory>/<name>/img/<lr_exp>ks/1x/<base>_mult_<k>.fits     (LR)
    <directory>/<name>/img/<hr_exp>ks/<m>x/<base>_mult_<k>.fits   (HR, m = res_mult)
    <directory>/<name>/agn/...                                    (the same two levels)
    <directory>/<name>/bkg/<lr_exp>ks/1x/bkg_<i>.fits

The LR images are `lr_hw` (the detector's native 411 x 403 by default) and
the HR ones `res_mult` times that, from an exposure `hr_exp / lr_exp` times
longer.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

from ..io.fits import write_image

NATIVE_HW: Tuple[int, int] = (411, 403)


def _rate(g: np.random.Generator, hw: Tuple[int, int], exposure_s: float, scale: int) -> np.ndarray:
    """Poisson counts of a flat background plus 4 point sources over
    `exposure_s` seconds, as a float32 rate image."""
    mean = exposure_s / 2e4  # counts per pixel of the background per 20 ks
    lam = np.full(hw, g.uniform(0.2, 1.0) * mean)
    for _ in range(4):
        y = int(g.integers(2 * scale, hw[0] - 3 * scale))
        x = int(g.integers(2 * scale, hw[1] - 3 * scale))
        lam[y : y + 2 * scale, x : x + 2 * scale] += g.uniform(5, 40) * mean
    return (g.poisson(lam) / exposure_s).astype(np.float32)


def write_sim_tree(
    directory: Path,
    name: str = "sim_dataset",
    n_base: int = 16,
    lr_hw: Tuple[int, int] = NATIVE_HW,
    res_mult: int = 2,
    lr_exp: int = 20,
    hr_exp: int = 100,
    n_agn: int = 4,
    n_bkg: int = 4,
    variants: int = 2,
    seed: int = 0,
) -> Path:
    """Write the tree under `directory` and return `directory`. Each of the
    `n_base` base names has `variants` LR and HR files (`_mult_0`, ...);
    the AGN set has `n_agn` base names, the background pool `n_bkg` files."""
    g = np.random.default_rng(seed)
    root = Path(directory) / name
    hr_hw = (lr_hw[0] * res_mult, lr_hw[1] * res_mult)

    def write_pair(kind: str, base: str):
        for k in range(variants):
            write_image(root / kind / f"{lr_exp}ks" / "1x" / f"{base}_mult_{k}.fits",
                        _rate(g, lr_hw, lr_exp * 1e3, 1))
            write_image(root / kind / f"{hr_exp}ks" / f"{res_mult}x" / f"{base}_mult_{k}.fits",
                        _rate(g, hr_hw, hr_exp * 1e3, res_mult))

    for i in range(n_base):
        write_pair("img", f"sim_{i:04d}")
    for i in range(n_agn):
        write_pair("agn", f"agn_{i:04d}")
    for i in range(n_bkg):
        write_image(root / "bkg" / f"{lr_exp}ks" / "1x" / f"bkg_{i:04d}.fits",
                    _rate(g, lr_hw, lr_exp * 1e3, 1))
    return Path(directory)
