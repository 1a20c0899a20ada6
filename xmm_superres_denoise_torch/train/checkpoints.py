"""Checkpoints in torch format, with best-val/loss tracking and resume.

The port of the JAX package's `train/checkpoints.py`, which keeps orbax
pytrees of the whole TrainState. Here a checkpoint is one `torch.save`
file, `<root>/ckpts/<step>.pt`, holding the model's and the optimizer's
full state dicts (`torch.distributed.checkpoint.state_dict`, which gathers
FSDP shards and strips DDP's wrapping, so one file serves every layout:
parameters keyed by the generator's own names), the step count and the
epoch's val/loss.

* Retention: the latest checkpoint plus the best `max_to_keep` by val/loss
  (JAX once lost resume-from-latest to a best-only policy); a non-finite
  val/loss ranks last and is never "best". `best.json` records the best
  step and val/loss.
* `save_emergency` / `restore_emergency`: one crash snapshot,
  `<root>/emergency.pt`, apart from the stepped checkpoints.
* Under several processes every rank takes part in gathering the state
  (FSDP needs it) and rank 0 writes; every rank reads to restore.
* `save_params_npz` / `load_params_npz` (from `utils/weights.py`): the
  parameters alone, as an npz in the Flax key layout of the model they
  hold (`layers_scan` for a model built with `scan_layers`), which the JAX
  package's `load_params_npz` and the port's serving CLI read.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.distributed import is_primary
from ..utils.weights import load_params_npz, save_params_npz  # noqa: F401  (re-exported)


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _write(obj: Any, path: Path) -> None:
    """torch.save to a temporary name, then rename: a crash mid-write leaves
    no truncated checkpoint under the real name."""
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def snapshot(state) -> Dict[str, Any]:
    """The full state of a `TrainState` on the host: {"model", "optimizer",
    "step"}, CPU copies (the optimizer's is None before its first step:
    reading an empty optimizer's state dict would take a step of it). A
    collective under FSDP; in a process group only rank 0 receives the
    state dicts, the other ranks empty ones."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        get_model_state_dict,
        get_optimizer_state_dict,
    )

    opts = StateDictOptions(full_state_dict=True, cpu_offload=True)
    model_sd = get_model_state_dict(state.module, options=opts)
    optim_sd = (get_optimizer_state_dict(state.module, state.optimizer, options=opts)
                if state.optimizer.state else None)

    def copy(t):
        return t.detach().clone() if isinstance(t, torch.Tensor) else t

    model_sd = {k: copy(v) for k, v in model_sd.items()}
    if optim_sd:
        optim_sd = {"state": {k: {n: copy(v) for n, v in s.items()}
                              for k, s in optim_sd["state"].items()},
                    "param_groups": optim_sd["param_groups"]}
    return {"model": model_sd, "optimizer": optim_sd, "step": int(state.step)}


def load_snapshot(state, payload: Dict[str, Any]):
    """Load a `snapshot` payload into `state` in place; returns `state`."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        set_model_state_dict,
        set_optimizer_state_dict,
    )

    opts = StateDictOptions(full_state_dict=True)
    set_model_state_dict(state.module, payload["model"], options=opts)
    if payload["optimizer"] is not None:
        set_optimizer_state_dict(state.module, state.optimizer, payload["optimizer"],
                                 options=opts)
    state.step = int(payload["step"])
    return state


class CheckpointManager:
    def __init__(self, root: Path, max_to_keep: int = 3):
        self.root = Path(root).resolve()
        self.dir = self.root / "ckpts"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._meta_path = self.root / "best.json"
        self._index_path = self.dir / "index.json"

    def _index(self) -> Dict[int, float]:
        """step -> val/loss of every kept checkpoint (inf for a non-finite one)."""
        if not self._index_path.exists():
            return {}
        return {int(k): float(v) for k, v in json.loads(self._index_path.read_text()).items()}

    def _path(self, step: int) -> Path:
        return self.dir / f"{int(step)}.pt"

    def save(self, step: int, state, val_loss: float) -> None:
        """Checkpoint `state` (a `TrainState`) as `step` with its val/loss,
        then drop what the retention policy does not keep."""
        payload = snapshot(state)
        if is_primary():
            metric = float(val_loss) if math.isfinite(val_loss) else float("inf")
            payload["val_loss"] = float(val_loss)
            _write(payload, self._path(step))
            index = self._index()
            index[int(step)] = metric
            latest = max(index)
            best = sorted(index, key=lambda s: (index[s], s))[: self.max_to_keep]
            for s in list(index):
                if s != latest and s not in best:
                    self._path(s).unlink(missing_ok=True)
                    del index[s]
            self._index_path.write_text(json.dumps({str(s): v for s, v in sorted(index.items())}))
            meta = self.best_metadata() or {"val_loss": float("inf")}
            if math.isfinite(val_loss) and float(val_loss) <= meta["val_loss"]:
                self._meta_path.write_text(
                    json.dumps({"step": int(step), "val_loss": float(val_loss)}))
        _barrier()

    def best_metadata(self) -> Optional[dict]:
        if self._meta_path.exists():
            return json.loads(self._meta_path.read_text())
        return None

    def restore(self, state, step: Optional[int] = None) -> Tuple[Any, int]:
        """Load `step` (or the latest) into `state`; returns (state, step)."""
        if step is None:
            step = self.latest_step()
        if step is None or not self._path(step).exists():
            raise FileNotFoundError(f"No checkpoint {step} under {self.root}")
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        return load_snapshot(state, payload), int(step)

    def best_step(self) -> int:
        """The step of the best checkpoint (best.json, else the lowest
        finite val/loss kept)."""
        meta = self.best_metadata()
        if meta is None:
            finite = {s: v for s, v in self._index().items() if math.isfinite(v)}
            if not finite:
                raise FileNotFoundError(f"No best checkpoint under {self.root}")
            return min(finite, key=lambda s: (finite[s], s))
        return int(meta["step"])

    def restore_best(self, state) -> Tuple[Any, int]:
        return self.restore(state, self.best_step())

    def best_model_state(self) -> Tuple[Dict[str, torch.Tensor], int]:
        """The best checkpoint's model state dict (CPU tensors, keyed by the
        generator's own names) and its step, without an optimizer: what
        serving and `export` read from a fit directory."""
        step = self.best_step()
        if not self._path(step).exists():
            raise FileNotFoundError(f"No checkpoint {step} under {self.root}")
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        return payload["model"], step

    def save_emergency(self, payload: Dict[str, Any]) -> Path:
        """Write one crash snapshot (a `snapshot` payload), apart from the
        stepped checkpoints so that it never touches best/latest."""
        path = self.root / "emergency.pt"
        _write(payload, path)
        return path

    def restore_emergency(self, state):
        """Load the crash snapshot into `state`; returns `state`."""
        path = self.root / "emergency.pt"
        if not path.exists():
            raise FileNotFoundError(f"No emergency checkpoint under {self.root}")
        return load_snapshot(state, torch.load(path, map_location="cpu", weights_only=True))

    def latest_step(self) -> Optional[int]:
        index = self._index()
        return max(index) if index else None
