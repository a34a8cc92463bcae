"""Distribution over torch.distributed (counterpart of goi_tpu/dist):
the ('data', 'model') mesh of ranks, the sharded render with its gather
and rows exchanges, the sharded distillation step and the multi-process
wiring."""

from goi_tpu_torch.dist.mesh import make_mesh, scene_sharding, shard_scene
from goi_tpu_torch.dist.multihost import (init_multihost,
                                          local_camera_indices,
                                          make_global_mesh,
                                          shard_scene_global)
from goi_tpu_torch.dist.render import render_sharded
from goi_tpu_torch.dist.shard import (make_sharded_distill_step, shard_batch,
                                      stack_cameras)

__all__ = ["make_mesh", "shard_scene", "scene_sharding",
           "make_sharded_distill_step", "render_sharded", "stack_cameras",
           "shard_batch", "init_multihost", "make_global_mesh",
           "shard_scene_global", "local_camera_indices"]
