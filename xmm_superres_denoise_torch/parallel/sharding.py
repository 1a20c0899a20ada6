"""Data parallelism (DDP) and parameter sharding (FSDP2) of the generators.

The port of the JAX package's `parallel/sharding.py`, where each parameter
leaf gets a NamedSharding over the `fsdp` mesh axis and XLA inserts the
all-gathers. Here:

* `shard_fsdp` applies FSDP2's `fully_shard` to each RRDB (the RRDB
  generators) or to each transformer block (`SwinTransformerBlock`, HAT's
  `HAB` and `OCAB`, `RestormerBlock`: the reference's wrap policy) and
  then to the root, over the mesh's "fsdp" dimension; when both dimensions
  are > 1 the 2-D mesh makes it HSDP (sharded over "fsdp", replicated over
  "data").
  The dense blocks stop caching their kernel pack (`cache_pack`): FSDP2
  gathers the parameters into fresh tensors for each forward, and one can
  land at a freed address with a matching version counter, so a cached
  pack could hold the previous step's weights.
* `wrap_ddp` wraps the model in `DistributedDataParallel` over the "data"
  dimension.

Both average the gradients over the ranks; the train step
(`train/steps.py`) scales each rank's loss by the world size so that the
reduced gradient is the global weighted sum, as JAX's is.
"""

from __future__ import annotations

from torch import nn

from .mesh import DATA_AXIS, FSDP_AXIS


def shard_fsdp(model: nn.Module, mesh) -> nn.Module:
    """`fully_shard` each RRDB or transformer block and the root; returns
    `model` (now an FSDPModule)."""
    from torch.distributed.fsdp import fully_shard

    from ..models.hat import HAB, OCAB
    from ..models.restormer import RestormerBlock
    from ..models.rrdb import RRDB, ResidualDenseBlock5C
    from ..models.swin_common import SwinTransformerBlock

    units = (RRDB, SwinTransformerBlock, HAB, OCAB, RestormerBlock)

    if mesh.size(mesh.mesh_dim_names.index(FSDP_AXIS)) == 1:
        raise ValueError("shard_fsdp needs an fsdp dimension > 1")
    shard_mesh = mesh if mesh.size(mesh.mesh_dim_names.index(DATA_AXIS)) > 1 else mesh[FSDP_AXIS]
    for m in model.modules():
        if isinstance(m, ResidualDenseBlock5C):
            m.cache_pack = False
    for m in list(model.modules()):
        if isinstance(m, units):
            fully_shard(m, mesh=shard_mesh)
    # explicit for the root too: by default FSDP2 keeps the root's
    # parameters gathered after a forward, and after an evaluation (no
    # backward to reshard them) the module would then hold plain tensors in
    # place of the sharded parameters that its optimizer steps
    fully_shard(model, mesh=shard_mesh, reshard_after_forward=True)
    return model


def wrap_ddp(model: nn.Module, mesh, device) -> nn.Module:
    """`DistributedDataParallel(model)` over the mesh's "data" group."""
    from torch.nn.parallel import DistributedDataParallel

    device_ids = [device] if device.type == "cuda" else None
    return DistributedDataParallel(model, device_ids=device_ids,
                                   process_group=mesh.get_group(DATA_AXIS))
