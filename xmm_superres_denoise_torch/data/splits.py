"""Deterministic train/val/test splits with pickle persistence.

A copy of the JAX package's `data/splits.py`: the same pickles and zips, so
one `res/splits`-style tree serves both packages.

Matches the reference's split layout (`datamodule.py:105-170`,
`data/tools.py:15-21`): index arrays pickled at
`res/splits/<dataset_name>/{train,val,test}/<mode>.p` (sim) or
`.../{exp}ks.p` (real); sim fractions 0.8/0.1/0.1 of base names, real
0.7/0.15/0.15 per exposure. Splits are over BASE names; the loader expands
them over the exposure axis (index i + k*base_count selects the same base at
the k-th exposure — the corrected version of the reference's
`indices * (i+1)` defect, SURVEY.md §2.4).

Also reads the reference's canonical split archives (`res/splits/*.zip`).
"""

from __future__ import annotations

import pickle
import zipfile
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

SIM_FRACTIONS = (0.8, 0.1, 0.1)
REAL_FRACTIONS = (0.7, 0.15, 0.15)
SPLIT_NAMES = ("train", "val", "test")


def random_split_indices(
    n: int, fractions: Sequence[float], seed: int = 0
) -> Dict[str, np.ndarray]:
    """Shuffled contiguous partition of range(n) by fractions."""
    perm = np.random.default_rng(seed).permutation(n)
    sizes = [int(np.floor(f * n)) for f in fractions]
    # distribute the remainder like torch.utils.data.random_split
    rem = n - sum(sizes)
    for i in range(rem):
        sizes[i % len(sizes)] += 1
    out = {}
    start = 0
    for name, size in zip(SPLIT_NAMES, sizes):
        out[name] = np.sort(perm[start : start + size])
        start += size
    return out


def save_splits(paths: List[Path], splits: Dict[str, np.ndarray]) -> None:
    for path, name in zip(paths, SPLIT_NAMES):
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(np.asarray(splits[name]), f)


def load_split(path: Path) -> np.ndarray:
    with open(path, "rb") as f:
        return np.asarray(pickle.load(f))


def load_splits_zip(zip_path: Path) -> Dict[str, np.ndarray]:
    """Read every pickled index array from a reference split archive."""
    out: Dict[str, np.ndarray] = {}
    with zipfile.ZipFile(zip_path) as z:
        for name in z.namelist():
            if name.endswith(".p"):
                out[name] = np.asarray(pickle.loads(z.read(name)))
    return out


def ensure_splits(
    split_dir: Path,
    leaf: str,
    n: int,
    fractions: Sequence[float] = SIM_FRACTIONS,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Load `{split_dir}/{train,val,test}/{leaf}` or create+persist them."""
    paths = [split_dir / name / leaf for name in SPLIT_NAMES]
    if all(p.exists() for p in paths):
        return {name: load_split(p) for name, p in zip(SPLIT_NAMES, paths)}
    splits = random_split_indices(n, fractions, seed)
    save_splits(paths, splits)
    return splits


def expand_indices(
    base_indices: np.ndarray, base_count: int, multiplicity: int
) -> np.ndarray:
    """Expand base-name indices over exposure/augmentation multiplicity.

    Offsets by k*base_count per replica (the corrected semantics of
    `datamodule.py:140-170`).
    """
    if multiplicity <= 1:
        return np.asarray(base_indices)
    return np.concatenate(
        [np.asarray(base_indices) + k * base_count for k in range(multiplicity)]
    )
