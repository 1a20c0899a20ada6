"""File discovery and LR/HR matching for the XMM datasets.

A copy of the JAX package's `data/catalog.py` (numpy and pathlib only; the
port imports nothing of that package). It rebuilds the reference's catalog
machinery (the reference's `data/tools.py:24-201`) without pandas:
the catalog is a plain `{exp: {base_name: [paths]}}` structure plus a sorted
list of base names, which is all the sampler needs. Matching semantics are
preserved:

  * images live under `<root>/<exp>ks/**/<res_mult_dir>` (e.g. `20ks/.../1x`),
  * a "base name" is the filename prefix before the split key
    (`_mult_` for sim, `_image_split_` for real — dataset.py:96),
  * only base names present for EVERY requested exposure (and in both LR and
    HR sets) are kept (tools.py:140-201).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set

SPLIT_KEY_SIM = "_mult_"
SPLIT_KEY_REAL = "_image_split_"


def find_img_dirs(
    parent: Path, exps: Sequence[int], res_mult_dir: str
) -> Dict[int, List[Path]]:
    """Per-exposure image directories (tools.py:24-36)."""
    out: Dict[int, List[Path]] = {}
    for exp in exps:
        pattern = f"{exp}ks/**/{res_mult_dir}" if res_mult_dir else f"{exp}ks/"
        dirs = sorted(parent.glob(pattern))
        if not dirs:
            raise FileNotFoundError(
                f"No image dirs matching '{pattern}' under {parent}"
            )
        out[exp] = dirs
    return out


def get_fits_files(dataset_dir: Path) -> List[Path]:
    if not dataset_dir.is_dir():
        raise FileNotFoundError(f"Dataset directory {dataset_dir} does not exist!")
    files = list(dataset_dir.glob("*.fits")) + list(dataset_dir.glob("*.fits.gz"))
    return sorted(files)


def find_img_files(img_dirs: Dict[int, List[Path]]) -> Dict[int, List[Path]]:
    return {
        exp: [f for d in dirs for f in get_fits_files(d)]
        for exp, dirs in img_dirs.items()
    }


def base_name_of(path: Path, split_key: str) -> str:
    return path.name.split(split_key)[0]


def common_base_names(files: Dict[int, List[Path]], split_key: str) -> Set[str]:
    """Base names present in every exposure (tools.py:140-158)."""
    per_exp = [
        {base_name_of(f, split_key) for f in flist} for flist in files.values()
    ]
    return set.intersection(*per_exp) if per_exp else set()


@dataclass
class Catalog:
    """Matched LR/HR file index keyed by (exposure, base name)."""

    split_key: str
    base_names: List[str]
    lr: Dict[int, Dict[str, List[Path]]]
    hr: Optional[Dict[int, Dict[str, List[Path]]]] = None

    @property
    def base_name_count(self) -> int:
        return len(self.base_names)

    def lr_files(self, exp: int, base_idx: int) -> List[Path]:
        return self.lr[exp][self.base_names[base_idx]]

    def hr_files(self, exp: int, base_idx: int) -> List[Path]:
        assert self.hr is not None
        return self.hr[exp][self.base_names[base_idx]]


def _group(
    files: Dict[int, List[Path]], names: Sequence[str], split_key: str
) -> Dict[int, Dict[str, List[Path]]]:
    keep = set(names)
    out: Dict[int, Dict[str, List[Path]]] = {}
    for exp, flist in files.items():
        grp: Dict[str, List[Path]] = {n: [] for n in names}
        for f in flist:
            b = base_name_of(f, split_key)
            if b in keep:
                grp[b].append(f)
        out[exp] = grp
    return out


def match_file_list(
    lr_files: Dict[int, List[Path]],
    hr_files: Optional[Dict[int, List[Path]]],
    split_key: str,
) -> Catalog:
    """Intersect LR/HR base names and build the catalog (tools.py:177-201)."""
    lr_names = common_base_names(lr_files, split_key)
    hr_names = (
        common_base_names(hr_files, split_key) if hr_files is not None else lr_names
    )
    names = sorted(lr_names & hr_names)
    if not names:
        raise ValueError(
            f"No base_names found in both LR and HR sets with split_key {split_key!r}"
        )
    return Catalog(
        split_key=split_key,
        base_names=names,
        lr=_group(lr_files, names, split_key),
        hr=_group(hr_files, names, split_key) if hr_files is not None else None,
    )


def build_catalog(
    parent: Path,
    lr_exps: Sequence[int],
    hr_exp: Optional[int],
    lr_res_dir: str,
    hr_res_dir: str,
    split_key: str,
) -> Catalog:
    lr_files = find_img_files(find_img_dirs(parent, lr_exps, lr_res_dir))
    hr_files = None
    if hr_exp:
        hr_files = find_img_files(find_img_dirs(parent, [hr_exp], hr_res_dir))
    return match_file_list(lr_files, hr_files, split_key)
