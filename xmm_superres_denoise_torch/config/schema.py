"""Serving-side config schema as plain dataclasses plus `tomllib`.

The port's counterpart of the JAX package's pydantic schema
(its `config/schema.py`): the dataset section
(`DatasetCfg` with its `LrDatasetCfg`/`HrDatasetCfg` halves) and the model
section (`ModelCfg` with an `RrdbCfg`), with the fields the run TOMLs set
and the serving path reads, checked in `__post_init__` the way the pydantic
validators check them. No pydantic: the port must import on a machine that
does not have it.

`load_run_config` reads a run TOML (`res/configs/runs/*.toml`) and the model
registry (`res/configs/models.toml`) into `(DatasetCfg, ModelCfg)`. Only the
RRDB models are ported; the others raise `NotImplementedError`.
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass
from enum import Enum
from pathlib import Path
from typing import List, Optional, Tuple, Union

RES_DIR = Path(__file__).resolve().parents[2] / "res"

_NOT_PORTED = (
    "is not ported to the PyTorch package yet (ROADMAP.md Queue 1, "
    "transformer zoo)"
)


class ConfigError(Exception):
    pass


class DatasetType(str, Enum):
    SIM = "sim"
    REAL = "real"
    BORING = "boring"


class BaseModels(str, Enum):
    ESR_GEN = "esr_gen"
    RRDB_DENOISE = "rrdb_denoise"
    SWINIR = "swinir"
    SWINFIR = "swinfir"
    DRCT = "drct"
    HAT = "hat"
    RESTORMER = "restormer"


def _one_of(name: str, value, options) -> None:
    if value not in options:
        raise ConfigError(f"{name} must be one of {tuple(options)}, got {value!r}")


def _positive(name: str, value) -> None:
    if isinstance(value, bool) or not isinstance(value, int) or value <= 0:
        raise ConfigError(f"{name} must be a positive integer, got {value!r}")


def _non_negative(name: str, value) -> None:
    if isinstance(value, bool) or not isinstance(value, (int, float)) or value < 0:
        raise ConfigError(f"{name} must be a non-negative number, got {value!r}")


@dataclass
class HrDatasetCfg:
    exp: int
    clamp_max: float
    res: int

    def __post_init__(self):
        _non_negative("hr.exp", self.exp)
        _non_negative("hr.clamp_max", self.clamp_max)
        _positive("hr.res", self.res)


@dataclass
class LrDatasetCfg:
    exps: List[int]
    clamp_max: float
    res: int
    bkg: Union[bool, int] = 1

    def __post_init__(self):
        for e in self.exps:
            _positive("lr.exps[]", e)
        _non_negative("lr.clamp_max", self.clamp_max)
        _positive("lr.res", self.res)


@dataclass
class DatasetCfg:
    lr: LrDatasetCfg
    hr: Optional[HrDatasetCfg] = None
    agn: Union[bool, int] = 1
    batch_size: int = 1
    crop_mode: str = "center"
    directory: Path = Path("")
    name: str = "sim_dataset"
    scaling: str = "sqrt"
    type: DatasetType = DatasetType.SIM

    def __post_init__(self):
        if isinstance(self.lr, dict):
            self.lr = LrDatasetCfg(**self.lr)
        if isinstance(self.hr, dict):
            self.hr = HrDatasetCfg(**self.hr)
        self.directory = Path(self.directory)
        self.type = DatasetType(self.type)
        _positive("batch_size", self.batch_size)
        _one_of("crop_mode", self.crop_mode, ("center", "random", "boresight"))
        _one_of("scaling", self.scaling, ("linear", "sqrt", "asinh", "log"))


@dataclass
class RrdbCfg:
    base_model: str
    in_channels: int = 1
    out_channels: int = 1
    filters: int = 32
    residual_blocks: int = 4

    def __post_init__(self):
        _one_of("model.base_model", self.base_model, ("esr_gen", "rrdb_denoise"))
        for name in ("in_channels", "out_channels", "filters", "residual_blocks"):
            _positive(f"model.{name}", getattr(self, name))


@dataclass
class ModelCfg:
    name: BaseModels
    model: RrdbCfg
    memory_efficient: bool = False
    batch_size: int = 1
    s2d_train: bool = False  # a training knob: accepted, not read when serving

    def __post_init__(self):
        self.name = BaseModels(self.name)
        if self.name not in (BaseModels.ESR_GEN, BaseModels.RRDB_DENOISE):
            raise NotImplementedError(f"model {self.name.value!r} {_NOT_PORTED}")
        if isinstance(self.model, dict):
            self.model = RrdbCfg(**self.model)
        _positive("batch_size", self.batch_size)


# registry keys that configure training only; the serving config drops them
_OPTIMIZER_KEYS = ("learning_rate", "betas")


def load_run_config(
    path: Union[str, Path], res_dir: Path = RES_DIR
) -> Tuple[DatasetCfg, ModelCfg]:
    """Run TOML -> (DatasetCfg, ModelCfg), as the JAX package's
    `cli.load_run_config` builds its dataset and model halves."""
    with open(path, "rb") as f:
        cfg = tomllib.load(f)

    # dataclass constructors raise TypeError on a key they do not declare,
    # so a typo in a run TOML is not dropped silently
    dataset = dict(cfg["dataset"])
    if dataset.get("hr", {}).get("exp") == 0:
        dataset["hr"] = None
    dataset_config = DatasetCfg(**dataset)

    model_dict = dict(cfg["model"])
    name = BaseModels(model_dict["name"])
    if name not in (BaseModels.ESR_GEN, BaseModels.RRDB_DENOISE):
        raise NotImplementedError(f"model {name.value!r} {_NOT_PORTED}")
    with open(Path(res_dir) / "configs" / "models.toml", "rb") as f:
        registry = tomllib.load(f)
    model_dict["model"] = {
        k: v for k, v in registry[name.value].items() if k not in _OPTIMIZER_KEYS
    }
    model_dict["batch_size"] = dataset_config.batch_size
    return dataset_config, ModelCfg(**model_dict)

__all__ = [
    "BaseModels", "ConfigError", "DatasetCfg", "DatasetType", "HrDatasetCfg",
    "LrDatasetCfg", "ModelCfg", "RrdbCfg", "load_run_config",
]
