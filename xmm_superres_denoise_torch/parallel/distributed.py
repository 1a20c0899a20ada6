"""Process-group initialization and the rank-zero guard.

The port of the JAX package's `parallel/distributed.py`, which joins JAX's
multi-host runtime. Here the launcher is `torchrun` (or any that sets its
environment): `initialize_distributed` reads `RANK`, `WORLD_SIZE`,
`LOCAL_RANK` and `MASTER_ADDR` / `MASTER_PORT` and joins the default
process group, with `nccl` on the card and `gloo` on the CPU. One process
(no `WORLD_SIZE`, or 1 without an address) is a no-op.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger("xmmsr")


def initialize_distributed(device_type: str = "cuda") -> Optional[int]:
    """Join the default process group when the environment describes one;
    returns the local rank (None for one process). `device_type` picks the
    backend: `nccl` for "cuda", `gloo` otherwise. On the card the process
    takes `cuda:<LOCAL_RANK>` as its current device."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and "MASTER_ADDR" not in os.environ:
        return None
    if dist.is_initialized():
        return int(os.environ.get("LOCAL_RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    backend = "nccl" if device_type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        backend,
        init_method="env://",
        world_size=world,
        rank=int(os.environ.get("RANK", "0")),
    )
    log.info("Joined process group (%s): rank %d/%d, local rank %d",
             backend, dist.get_rank(), world, local_rank)
    return local_rank


def is_primary() -> bool:
    """Rank-zero guard: True for one process and for rank 0 of a group."""
    return not dist.is_initialized() or dist.get_rank() == 0
