from .schema import (
    BaseModels,
    ConfigError,
    DatasetCfg,
    DatasetType,
    HrDatasetCfg,
    LossCfg,
    LrDatasetCfg,
    MeshCfg,
    ModelCfg,
    OptimizerCfg,
    RrdbCfg,
    TrainerCfg,
    load_run_config,
)

__all__ = [
    "BaseModels", "ConfigError", "DatasetCfg", "DatasetType", "HrDatasetCfg",
    "LossCfg", "LrDatasetCfg", "MeshCfg", "ModelCfg", "OptimizerCfg", "RrdbCfg",
    "TrainerCfg", "load_run_config",
]
