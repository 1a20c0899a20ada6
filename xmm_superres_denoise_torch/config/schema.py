"""Config schema as plain dataclasses plus `tomllib`.

The port's counterpart of the JAX package's pydantic schema (its
`config/schema.py`): the dataset section (`DatasetCfg` with its
`LrDatasetCfg`/`HrDatasetCfg` halves), the model section (`ModelCfg` with an
`RrdbCfg` and an `OptimizerCfg`), the trainer section (`TrainerCfg` with its
`MeshCfg`) and the loss weights (`LossCfg`), with the fields the JAX schema
declares, checked in `__post_init__` the way the pydantic validators check
them. No pydantic: the port must import on a machine that does not have it.
Unlike pydantic, a constructor refuses a key it does not declare.

`load_run_config` reads a run TOML (`res/configs/runs/*.toml`) and the model
registry (`res/configs/models.toml`) into `(DatasetCfg, ModelCfg)`; the CLI's
`load_run_config` adds the trainer section and the loss tables. Only the
RRDB models are ported; the others raise `NotImplementedError`.
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, field
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


class ImageType(str, Enum):
    IMG = "img"
    AGN = "agn"
    BKG = "bkg"


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


def _empty_to_none(value) -> Optional[Path]:
    if value == "" or value is None:
        return None
    return Path(value)


def _mask_path(value) -> Optional[Path]:
    """An optional detector mask: "" means none; a given path must be a file."""
    path = _empty_to_none(value)
    if path is not None:
        if not path.exists():
            raise FileNotFoundError(f"Detector mask does not exist at '{path}'!")
        if path.is_dir():
            raise FileExistsError(f"Detector mask path is a directory: '{path}'")
    return path


@dataclass
class HrDatasetCfg:
    exp: int
    clamp_max: float
    res: int
    det_mask: Optional[Path] = None
    agn: bool = True

    def __post_init__(self):
        _non_negative("hr.exp", self.exp)
        _non_negative("hr.clamp_max", self.clamp_max)
        _positive("hr.res", self.res)
        self.det_mask = _mask_path(self.det_mask)


@dataclass
class LrDatasetCfg:
    exps: List[int]
    clamp_max: float
    res: int
    bkg: Union[bool, int] = 1
    det_mask: Optional[Path] = None

    def __post_init__(self):
        for e in self.exps:
            _positive("lr.exps[]", e)
        _non_negative("lr.clamp_max", self.clamp_max)
        _positive("lr.res", self.res)
        self.det_mask = _mask_path(self.det_mask)


@dataclass
class DatasetCfg:
    lr: LrDatasetCfg
    hr: Optional[HrDatasetCfg] = None
    agn: Union[bool, int] = 1
    batch_size: int = 1
    check_files: bool = False
    debug: bool = False
    comb_hr: bool = False
    crop_mode: str = "center"
    directory: Path = Path("")
    mode: str = "img"
    name: str = "sim_dataset"
    scaling: str = "sqrt"
    type: DatasetType = DatasetType.SIM
    boring_size: int = 10000  # the synthetic dataset's size

    def __post_init__(self):
        if isinstance(self.lr, dict):
            self.lr = LrDatasetCfg(**self.lr)
        if isinstance(self.hr, dict):
            self.hr = HrDatasetCfg(**self.hr)
        self.directory = Path(self.directory)
        self.type = DatasetType(self.type)
        _positive("batch_size", self.batch_size)
        _positive("boring_size", self.boring_size)
        _one_of("crop_mode", self.crop_mode, ("center", "random", "boresight"))
        _one_of("mode", self.mode, ("img", "agn"))
        _one_of("scaling", self.scaling, ("linear", "sqrt", "asinh", "log"))

    @property
    def res_mult(self) -> int:
        if self.type is DatasetType.REAL or self.hr is None:
            return 1  # no HR side (denoise-style / input-only datasets)
        return self.hr.res // self.lr.res

    def _mode_dir(self, mode: ImageType) -> Path:
        if self.type is DatasetType.SIM:
            d = self.directory / self.name / mode.value
            if mode is ImageType.BKG and not d.exists():
                # the shipped example data names this directory "background"
                alt = self.directory / self.name / "background"
                if alt.exists():
                    return alt
            return d
        if mode is ImageType.IMG and self.type is DatasetType.REAL:
            return self.directory / self.name
        raise ConfigError(
            f"No {mode.value.upper()} directory for dataset type '{self.type.value}'"
        )

    @property
    def img_dir(self) -> Path:
        return self._mode_dir(ImageType.IMG)

    @property
    def agn_dir(self) -> Path:
        return self._mode_dir(ImageType.AGN)

    @property
    def bkg_dir(self) -> Path:
        return self._mode_dir(ImageType.BKG)


@dataclass
class OptimizerCfg:
    learning_rate: float
    betas: Tuple[float, float] = (0.9, 0.999)

    def __post_init__(self):
        _non_negative("optimizer.learning_rate", self.learning_rate)
        self.learning_rate = float(self.learning_rate)
        betas = tuple(self.betas)
        if len(betas) != 2:
            raise ConfigError(f"optimizer.betas must be two numbers, got {self.betas!r}")
        for b in betas:
            _non_negative("optimizer.betas[]", b)
        self.betas = tuple(float(b) for b in betas)


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
    optimizer: Optional[OptimizerCfg] = None  # training only; the registry's

    def __post_init__(self):
        self.name = BaseModels(self.name)
        if self.name not in (BaseModels.ESR_GEN, BaseModels.RRDB_DENOISE):
            raise NotImplementedError(f"model {self.name.value!r} {_NOT_PORTED}")
        if isinstance(self.model, dict):
            self.model = RrdbCfg(**self.model)
        if isinstance(self.optimizer, dict):
            self.optimizer = OptimizerCfg(**self.optimizer)
        _positive("batch_size", self.batch_size)


@dataclass
class MeshCfg:
    """Device-mesh topology of a training run: `data` the data-parallel axis
    ("auto" = every local device), `fsdp` the parameter-sharding axis,
    `remat` activation checkpointing (forces the model's
    `memory_efficient`; the CLI's `load_run_config` applies it)."""

    data: Union[int, str] = "auto"
    fsdp: int = 1
    remat: bool = False

    def __post_init__(self):
        if self.data != "auto":
            _positive("mesh.data", self.data)
        _positive("mesh.fsdp", self.fsdp)


# Lightning-style spellings of the training precision
_PRECISION = {
    "32": "f32", 32: "f32", "32-true": "f32", "fp32": "f32",
    "bf16-mixed": "bf16", "bf16-true": "bf16",
}


@dataclass
class TrainerCfg:
    accelerator: str = "auto"
    mesh: MeshCfg = field(default_factory=MeshCfg)
    checkpoint_path: Optional[Path] = None
    checkpoint_root: Optional[Path] = None
    epochs: int = 50
    log_images_every_n_epochs: int = 0
    seed: int = 0
    precision: str = "f32"
    accumulate_grad_batches: int = 1
    early_stopping_patience: int = 0
    early_stopping_min_delta: float = 0.0
    gradient_clip_val: float = 0.0
    # legacy reference keys: strategy="fsdp" defaults the mesh to a 2-way
    # fsdp axis when the mesh section did not already shard the params
    strategy: str = "auto"
    devices: Union[int, str] = "auto"

    def __post_init__(self):
        if isinstance(self.mesh, dict):
            self.mesh = MeshCfg(**self.mesh)
        _one_of("accelerator", self.accelerator, ("auto", "cpu", "tpu"))
        self.checkpoint_path = _empty_to_none(self.checkpoint_path)
        self.checkpoint_root = _empty_to_none(self.checkpoint_root)
        _positive("epochs", self.epochs)
        _non_negative("log_images_every_n_epochs", self.log_images_every_n_epochs)
        if isinstance(self.seed, bool) or not isinstance(self.seed, int):
            raise ConfigError(f"seed must be an integer, got {self.seed!r}")
        self.precision = _PRECISION.get(self.precision, self.precision)
        _one_of("precision", self.precision, ("f32", "bf16"))
        _positive("accumulate_grad_batches", self.accumulate_grad_batches)
        _non_negative("early_stopping_patience", self.early_stopping_patience)
        _non_negative("early_stopping_min_delta", self.early_stopping_min_delta)
        _non_negative("gradient_clip_val", self.gradient_clip_val)
        _one_of("strategy", self.strategy, ("auto", "ddp", "fsdp"))
        if self.devices != "auto":
            _positive("devices", self.devices)
        if self.strategy == "fsdp" and self.mesh.fsdp == 1:
            self.mesh.fsdp = 2


_LOSS_TERMS = ("l1", "poisson", "psnr", "ssim", "ms_ssim")


@dataclass
class LossCfg:
    """Relative weights of the loss terms, each in [0, 1], their sum in (0, 1]."""

    l1: float = 0.0
    poisson: float = 0.0
    psnr: float = 0.0
    ssim: float = 0.0
    ms_ssim: float = 0.0

    def __post_init__(self):
        for name in _LOSS_TERMS:
            value = getattr(self, name)
            _non_negative(f"loss.{name}", value)
            if value > 1:
                raise ConfigError(f"loss.{name} must be at most 1, got {value!r}")
            setattr(self, name, float(value))
        s = self.l1 + self.poisson + self.psnr + self.ssim + self.ms_ssim
        if not 0 < s <= 1:
            raise ConfigError(
                f"Sum of relative percentages has to be between 0 and 1, got {s}!"
            )


# registry keys that configure the optimizer, not the model
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
    entry = registry[name.value]
    model_dict["model"] = {k: v for k, v in entry.items() if k not in _OPTIMIZER_KEYS}
    model_dict["optimizer"] = {k: entry[k] for k in _OPTIMIZER_KEYS if k in entry}
    model_dict["batch_size"] = dataset_config.batch_size
    return dataset_config, ModelCfg(**model_dict)

__all__ = [
    "BaseModels", "ConfigError", "DatasetCfg", "DatasetType", "HrDatasetCfg",
    "LossCfg", "LrDatasetCfg", "MeshCfg", "ModelCfg", "OptimizerCfg", "RrdbCfg",
    "TrainerCfg", "load_run_config",
]
