"""Multi-chip parallelism: device mesh, sharded rendering, sharded training.

The reference's only parallelism is rayon par_iter over pixels within one
process (ref: src/renderer/mod.rs:106). The accelerator equivalent is data
parallelism over pixel tiles via ``jax.shard_map`` on a 1-D device mesh, with
the scene/BVH replicated in every device's memory and a gradient ``psum``
(over NVLink on one host) for the differentiable path (SURVEY §2c, §7).
"""

from path_tracer_tpu.parallel.mesh import default_mesh  # noqa: F401
from path_tracer_tpu.parallel.render import render_sharded  # noqa: F401
from path_tracer_tpu.parallel.train import (  # noqa: F401
    PARAM_FIELDS,
    apply_params,
    get_params,
    make_train_step,
)
