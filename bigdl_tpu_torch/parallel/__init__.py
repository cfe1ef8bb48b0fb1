"""Distribution over ``torch.distributed`` (counterpart of
bigdl_tpu/parallel): the mesh and its axes, the collectives, the
sharding rules; ``pipeline`` and ``pipeline_model`` hold the pipeline
schedules and the stage partition."""
from bigdl_tpu_torch.parallel import collectives
from bigdl_tpu_torch.parallel.mesh import (data_parallel_mesh, hybrid_mesh,
                                           make_mesh)
from bigdl_tpu_torch.parallel.sharding import (shard_params_rule,
                                               zero1_tp_rule)

__all__ = [
    "make_mesh", "data_parallel_mesh", "hybrid_mesh", "collectives",
    "shard_params_rule", "zero1_tp_rule",
]
