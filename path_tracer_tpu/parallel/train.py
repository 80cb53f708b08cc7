"""Sharded differentiable render step ("training step" analog).

The reference has no training loop — the DP-gradient analog mandated by
BASELINE.md is: differentiate the rendered image w.r.t. continuous scene
parameters (material factors, light colors, emission, background), shard the
pixel wavefront over the mesh, and all-reduce parameter gradients with
``psum`` over ICI (SURVEY §2c). This is the inverse-rendering workflow: fit
scene parameters to a target image by gradient descent.
"""
from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from path_tracer_tpu.models.integrator import IntegratorSpec, render_wavefront
from path_tracer_tpu.parallel.mesh import DP_AXIS

# Continuous leaves of DeviceScene that gradients flow into. Discrete events
# (hit selection, alpha accepts, RR kills, sampled directions) are detached
# inside the integrator; as a consequence, geometry-moving parameters
# (point_pos, cam_to_world) get the standard detached-sampling estimator —
# exact through shading terms (falloff, cos, ray direction), biased where a
# parameter would move the hit point itself.
PARAM_FIELDS = (
    "mat_albedo_factor",
    "mat_emissive_factor",
    "mat_metalness_factor",
    "mat_roughness_factor",
    "point_color",
    "point_pos",
    "dir_color",
    # Directional-light direction (ref light.rs:33-36): used RAW (the
    # reference never normalizes it) in eval_direct and the shadow
    # direction, so its gradient flows through shading exactly.
    "dir_dir",
    "background",
    "cam_to_world",
    # Vertical fov in radians (ref camera.rs:6-13): flows through camera
    # ray generation; exact through the triangle/sphere hit-point
    # reparameterizations away from silhouettes.
    "cam_fov",
    # Sphere geometry (ref model.rs:26-63): first-order-exact via the
    # differentiable quadratic-root reparameterization in _surface
    # (straight-through; hit selection stays a detached discrete event).
    "sph_center",
    "sph_radius",
    # The full texture atlas [P,3]: the nearest-neighbor fetch is a gather,
    # whose transpose is a scatter-add into the atlas — per-texel gradients
    # for every albedo/emissive/opacity/metalness/roughness/normal texture
    # (FD-gated by tests/test_gradients.py::test_texture_texel_grad...).
    "tex_data",
)


def get_params(scene) -> dict:
    """Extract the trainable parameter pytree from a DeviceScene."""
    return {f: getattr(scene, f) for f in PARAM_FIELDS}


def apply_params(scene, params: dict):
    """Rebuild the scene with updated parameters.

    Besides the live mat_* tables (read by the differentiable path), the
    forward render (differentiable=False) reads material factors from the
    BAKED sl_attr row columns — so any material-factor update must refresh
    those columns too, or renders of the fitted scene would silently use the
    pre-training values (two sources of truth). tex_data updates need no
    refresh DURING training (both the differentiable sampler and the walk
    kernels read live texels); before forward-rendering a scene whose
    tex_data was trained, call refresh_baked_textures once (host-side).
    """
    scene = dataclasses.replace(scene, **params)
    if any(f.startswith("mat_") for f in params):
        scene = rebake_material_rows(scene)
    if "sph_center" in params or "sph_radius" in params:
        scene = repack_spheres(scene)
    return scene


def repack_spheres(scene):
    """Refresh the lane-major Pallas sphere table [4, S_pad] from the live
    sph_center/sph_radius arrays (device-side; mirrors
    device_scene._pack_spheres — padding columns stay guaranteed misses
    because the padded rows of sph_center are at 1e30 with radius 0)."""
    import jax.numpy as jnp

    sp = scene.sph_packed_t
    ns = scene.sph_center.shape[0]
    sp = sp.at[0:3, :ns].set(scene.sph_center.T)
    sp = sp.at[3, :ns].set(scene.sph_radius)
    return dataclasses.replace(scene, sph_packed_t=sp)


def rebake_material_rows(scene):
    """Refresh sl_attr's baked material columns from the live mat_* tables
    (device-side gathers; the per-row model id lives in column 27)."""
    import jax.numpy as jnp

    from path_tracer_tpu.scene import device_scene as ds

    attr = scene.sl_attr
    mid = attr[:, 27].astype(jnp.int32)
    attr = attr.at[:, ds.ATTR_ALBEDO_F:ds.ATTR_ALBEDO_F + 3].set(
        scene.mat_albedo_factor[mid])
    attr = attr.at[:, ds.ATTR_EMISSIVE_F:ds.ATTR_EMISSIVE_F + 3].set(
        scene.mat_emissive_factor[mid])
    attr = attr.at[:, ds.ATTR_OPACITY_F].set(scene.mat_opacity_factor[mid])
    attr = attr.at[:, ds.ATTR_METAL_F].set(scene.mat_metalness_factor[mid])
    attr = attr.at[:, ds.ATTR_ROUGH_F].set(scene.mat_roughness_factor[mid])
    attr = attr.at[:, ds.ATTR_IOR].set(scene.mat_ior[mid])
    return dataclasses.replace(scene, sl_attr=attr)


def refresh_baked_textures(scene):
    """Host-side rebuild of the BAKED texel tables from the live atlas —
    call ONCE after a training run that updated ``tex_data`` before
    rendering the fitted scene in forward mode (differentiable=False).

    Training itself never needs this: the differentiable path samples the
    live tex_data directly. But forward rendering reads two baked tables
    built from the ORIGINAL atlas: tex_wide (the channel-interleaved
    wide-texel table) and tr_tex8 (a u8 page plane of the transparent
    textures). This rebuilds tex_wide value-for-value (same layout —
    texture shapes cannot change) and re-quantizes tr_tex8; if the trained
    texels are no longer exactly u8/255 (generic after gradient steps),
    tr_kernel_ok is cleared rather than silently quantizing.

    NOT jit-safe (host readback of tex_data): do this once, at export time.
    """
    import numpy as np

    from path_tracer_tpu.scene import device_scene as ds

    atlas_data = np.asarray(scene.tex_data)
    updates = {}
    if not scene.no_textures and any(scene.wide_covered):
        mats = {
            "albedo_t": np.asarray(scene.mat_albedo_tex),
            "emissive_t": np.asarray(scene.mat_emissive_tex),
            "opacity_t": np.asarray(scene.mat_opacity_tex),
            "metal_t": np.asarray(scene.mat_metalness_tex),
            "rough_t": np.asarray(scene.mat_roughness_tex),
            "normal_t": np.asarray(scene.mat_normal_tex),
        }
        tex_wide_np, _, _, _, covered = ds._build_wide_tex(
            mats, atlas_data, np.asarray(scene.tex_offset),
            np.asarray(scene.tex_width), np.asarray(scene.tex_height))
        assert covered == scene.wide_covered  # layout is value-invariant
        assert tex_wide_np.shape == scene.tex_wide.shape
        updates["tex_wide"] = jnp.asarray(tex_wide_np)
    if scene.tr_kernel_ok and scene.tr_textured:
        lut = np.asarray(scene.tr_lut)[0]
        hp, wp = scene.tr_tex8.shape
        tex8 = np.zeros((hp, wp), np.float32)
        exact = True
        for off, w, h, yb in scene.tr_pages:
            plane = atlas_data[off : off + w * h, 0]
            ru = np.round(plane.astype(np.float64) * 255.0)
            if not np.array_equal(plane, lut[np.clip(ru, 0, 255)
                                             .astype(np.int32)]):
                exact = False
                break
            tex8[yb : yb + h, :w] = ru.reshape(h, w)
        if exact:
            updates["tr_tex8"] = jnp.asarray(tex8, jnp.bfloat16)
        else:
            updates["tr_kernel_ok"] = False
    return dataclasses.replace(scene, **updates) if updates else scene


def make_train_step(mesh, width: int, height: int, spec: IntegratorSpec,
                    n_samples: int = 1, lr: float = 1e-2, axis: str = DP_AXIS):
    """Jitted sharded step: (params, scene, pixel_ids, target, sample_id) →
    (new_params, loss).

    pixel_ids [R] and target [R,3] shard over ``axis``; params and scene are
    replicated. The loss is summed over all shards (psum) and parameter
    gradients are psum-reduced before the SGD update, so every device applies
    the identical update — standard DP.
    """

    def local_step(params, scene, ids, target, sample_id):
        def loss_fn(params):
            s = apply_params(scene, params)

            def body(acc, k):
                rad = render_wavefront(s, ids, width, height, sample_id + k,
                                       spec)
                return acc + rad, None

            init = jnp.zeros((ids.shape[0], 3), jnp.float32)
            acc, _ = jax.lax.scan(body, init, jnp.arange(n_samples))
            img = acc / float(n_samples)
            return jnp.sum((img - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        loss = jax.lax.psum(loss, axis)
        grads = jax.lax.psum(grads, axis)
        new_params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params,
                                            grads)
        return new_params, loss

    sharded = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)
