from .distributed import initialize_distributed, is_primary
from .mesh import DATA_AXIS, FSDP_AXIS, make_mesh, mesh_shape, serving_devices
from .sharding import shard_fsdp, wrap_ddp

__all__ = [
    "DATA_AXIS", "FSDP_AXIS", "initialize_distributed", "is_primary", "make_mesh",
    "mesh_shape", "serving_devices", "shard_fsdp", "wrap_ddp",
]
