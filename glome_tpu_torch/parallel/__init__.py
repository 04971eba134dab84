from .mesh import (make_mesh, shard_rays, sharded_render_fn,
                   sharded_train_step_fn, init_distributed)
