from vsr_tpu_torch.parallel.mesh import (
    create_mesh,
    default_inference_mesh,
    replicate,
)

__all__ = ["create_mesh", "default_inference_mesh", "replicate"]
