"""The (data, fsdp) device mesh.

The port of the JAX package's `parallel/mesh.py`: JAX builds a `Mesh`
with a `data` axis (data parallelism) and an `fsdp` axis (parameter
sharding) over its devices; here it is a `DeviceMesh` with the dimensions
("data", "fsdp") over the processes of the default group, one card (or
CPU process) each. Batches need no placement: each rank takes its own
share from the loader (`data/datamodule.py: XmmDataModule.loader`, which
pads with `pad_batch`).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"


def mesh_shape(data: Union[int, str], fsdp: int, world_size: int) -> Tuple[int, int]:
    """(data, fsdp) for `world_size` processes: "auto" takes world // fsdp,
    as JAX's `make_mesh` does; data x fsdp must equal the world size."""
    if data == "auto":
        if world_size % fsdp:
            raise ValueError(f"{world_size} processes not divisible by fsdp={fsdp}")
        data = world_size // fsdp
    if data * fsdp != world_size:
        raise ValueError(f"mesh {data}x{fsdp} needs {data * fsdp} processes, the group has "
                         f"{world_size}")
    return int(data), int(fsdp)


def make_mesh(data: Union[int, str] = "auto", fsdp: int = 1, device_type: str = "cuda"):
    """`init_device_mesh` over the default process group, dimensions
    ("data", "fsdp")."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = mesh_shape(data, fsdp, dist.get_world_size())
    return init_device_mesh(device_type, shape, mesh_dim_names=(DATA_AXIS, FSDP_AXIS))
