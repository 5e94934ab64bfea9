"""Device meshes and row sharding over local devices or a process group."""

from tweediemix_tpu_torch.parallel.mesh import (
    Mesh,
    concept_sharded_unet_fn,
    make_mesh,
    replicate,
    seed_sharded_unet_fn,
    shard_batch,
)

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate", "concept_sharded_unet_fn",
           "seed_sharded_unet_fn"]
