from vsr_tpu_torch.parallel.distributed import TrainingMesh, init_distributed
from vsr_tpu_torch.parallel.mesh import (
    create_mesh,
    default_inference_mesh,
    param_sharding_rules,
    replicate,
    shard_params,
)

__all__ = ["TrainingMesh", "create_mesh", "default_inference_mesh", "init_distributed",
           "param_sharding_rules", "replicate", "shard_params"]
