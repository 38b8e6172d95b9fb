from pepr_tpu_torch.parallel.mesh import (default_mesh, shard_sites,
                                          sharded_loglik,
                                          sharded_replicate_blopt)

__all__ = ["default_mesh", "shard_sites", "sharded_loglik",
           "sharded_replicate_blopt"]
