from .checkpoints import CheckpointManager, load_params_npz, save_params_npz
from .loop import FitResult, Trainer
from .loss import create_loss, load_scaling_tables
from .steps import (
    TrainState,
    Tx,
    accum_add,
    clamped_apply,
    make_accum_steps,
    make_eval_step,
    make_fsdp_train_step,
    make_train_step,
)

__all__ = [
    "CheckpointManager", "FitResult", "Trainer", "TrainState", "Tx", "accum_add",
    "clamped_apply", "create_loss", "load_params_npz", "load_scaling_tables",
    "make_accum_steps", "make_eval_step", "make_fsdp_train_step",
    "make_train_step", "save_params_npz",
]
