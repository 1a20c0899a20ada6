from .schema import (
    BaseModels,
    ConfigError,
    DatasetCfg,
    DatasetType,
    HrDatasetCfg,
    LrDatasetCfg,
    ModelCfg,
    RrdbCfg,
    load_run_config,
)

__all__ = [
    "BaseModels", "ConfigError", "DatasetCfg", "DatasetType", "HrDatasetCfg",
    "LrDatasetCfg", "ModelCfg", "RrdbCfg", "load_run_config",
]
