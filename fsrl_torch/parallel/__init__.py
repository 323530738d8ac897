"""Data parallelism over ``torch.distributed``."""

from fsrl_torch.parallel.mesh import (DPGroup, EnvRows, env_sharding,
                                      init_multihost, make_mesh,
                                      make_multihost_mesh, replicate_tree,
                                      replicated, shard_env_state)

__all__ = ["DPGroup", "EnvRows", "env_sharding", "init_multihost",
           "make_mesh", "make_multihost_mesh", "replicate_tree",
           "replicated", "shard_env_state"]
