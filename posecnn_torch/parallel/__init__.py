from posecnn_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    initialize_distributed,
    param_sharding,
)

__all__ = ["Mesh", "create_mesh", "initialize_distributed", "param_sharding"]
