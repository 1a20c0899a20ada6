"""Dataset sources. So far the detector mask reader the serving CLI needs.

The port of `load_det_mask` from the JAX package's `data/datasets.py`; the
datasets themselves come with the training path.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from ..io.fits import read_image


def load_det_mask(path: Optional[Path]) -> Optional[np.ndarray]:
    """A detector mask FITS image as float32, or None for no mask."""
    if path is None:
        return None
    img, _ = read_image(path)
    return np.ascontiguousarray(img, dtype=np.float32)
