from atlaspatch_tpu_torch.parallel.mesh import embedding_mesh, shard_batch
from atlaspatch_tpu_torch.parallel.multihost import host_shard, maybe_init_distributed

__all__ = ["embedding_mesh", "shard_batch", "host_shard", "maybe_init_distributed"]
