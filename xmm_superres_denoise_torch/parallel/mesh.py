"""The (data, fsdp) device mesh.

The port of the JAX package's `parallel/mesh.py`: JAX builds a `Mesh`
with a `data` axis (data parallelism) and an `fsdp` axis (parameter
sharding) over its devices; here it is a `DeviceMesh` with the dimensions
("data", "fsdp") over the processes of the default group, one card (or
CPU process) each. Batches need no placement: each rank takes its own
share from the loader (`data/datamodule.py: XmmDataModule.loader`, which
pads with `pad_batch`).

Serving needs no process group: `serving_devices` is the data axis that
JAX's `make_mesh(data=N)` builds over the local devices for the serving
engine, which one process drives (`infer/run_file.py: InferenceEngine(mesh=...)`).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
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


def serving_devices(data: int, device_type: str = "cuda") -> Tuple[torch.device, ...]:
    """The serving engine's data axis over this process's devices: 0 or 1
    gives one card, -1 every card `torch.cuda.device_count()` reports, N > 1
    cards cuda:0..N-1. Asking for more cards than are visible raises
    ValueError. On the CPU (`device_type="cpu"`) the axis is N entries of
    the one host device (-1 gives one), as the JAX package's tests serve
    over virtual CPU devices."""
    if data < -1:
        raise ValueError(f"mesh data axis {data}: expected -1 (all), 0, 1 or N > 1")
    if device_type == "cpu":
        return (torch.device("cpu"),) * max(1, data)
    if device_type != "cuda":
        raise ValueError(f"device type {device_type!r}: expected 'cuda' or 'cpu'")
    visible = torch.cuda.device_count()
    n = visible if data == -1 else max(1, data)
    if n < 1 or n > visible:
        raise ValueError(f"mesh data axis {data} needs {max(n, 1)} card(s), {visible} visible")
    return tuple(torch.device("cuda", i) for i in range(n))
