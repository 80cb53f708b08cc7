"""Camera ray generation (vectorized over a pixel-id wavefront).

Reference semantics (src/renderer/mod.rs:114-124):
  screen_x = ((x + jitter_x)/W*2 - 1) * tan(fov/2) * aspect
  screen_y = (1 - (y + jitter_y)/H*2) * tan(fov/2)
  dir_cam  = normalize([screen_x, screen_y, -1])
  dir_world = M[:3,:3] @ dir_cam   (w=0 transform, camera.rs:36-39 —
                                    NOT re-normalized after the transform)
  origin    = M[:3,3]              (camera.rs:42-48)
fov is the VERTICAL field of view in radians.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from path_tracer_tpu.ops import rng


def generate_rays(pixel_ids, width: int, height: int, scene, sample_id, seed: int,
                  jitter: bool = True):
    """pixel_ids: [R] int32 flattened as y*width + x. Returns (origins [R,3],
    dirs [R,3])."""
    x = (pixel_ids % width).astype(jnp.float32)
    y = (pixel_ids // width).astype(jnp.float32)
    if jitter:
        jx = rng.uniform(pixel_ids, sample_id, rng.SITE_CAM_X, seed)
        jy = rng.uniform(pixel_ids, sample_id, rng.SITE_CAM_Y, seed)
    else:
        # Debug/AOV mode uses pixel centers (ref: debug_renderer.rs:24,28).
        jx = jnp.float32(0.5)
        jy = jnp.float32(0.5)

    wf = jnp.float32(width)
    hf = jnp.float32(height)
    aspect = wf / hf
    tan_half = jnp.tan(scene.cam_fov * 0.5)

    sx = ((x + jx) / wf * 2.0 - 1.0) * tan_half * aspect
    sy = (1.0 - (y + jy) / hf * 2.0) * tan_half

    d_cam = jnp.stack([sx, sy, -jnp.ones_like(sx)], axis=-1)
    d_cam = d_cam / jnp.linalg.norm(d_cam, axis=-1, keepdims=True)
    # HIGHEST: an f32 matmul may otherwise run in TF32 on the GPU, which
    # keeps ~3 decimal digits of the ray direction.
    d_world = jnp.matmul(d_cam, scene.cam_to_world[:3, :3].T,
                         precision=jax.lax.Precision.HIGHEST)
    origin = jnp.broadcast_to(scene.cam_to_world[:3, 3], d_world.shape)
    return origin, d_world
