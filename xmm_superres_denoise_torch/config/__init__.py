from .schema import (
    BaseModels,
    ConfigError,
    DatasetCfg,
    DatasetType,
    HrDatasetCfg,
    ImageType,
    LossCfg,
    LrDatasetCfg,
    MeshCfg,
    ModelCfg,
    OptimizerCfg,
    RestormerCfg,
    RrdbCfg,
    TrainerCfg,
    TransformerCfg,
    load_run_config,
)

__all__ = [
    "BaseModels", "ConfigError", "DatasetCfg", "DatasetType", "HrDatasetCfg",
    "ImageType", "LossCfg", "LrDatasetCfg", "MeshCfg", "ModelCfg", "OptimizerCfg",
    "RestormerCfg", "RrdbCfg", "TrainerCfg", "TransformerCfg", "load_run_config",
]
