"""Regression gates for the round-2 review findings.

Each test pins one of the defects found by the code review of the round-2
diff: the RNG site-layout collision for deep alpha walks, stale baked
material rows after apply_params, the profile null-int crash deferral, the
rebalance divisibility trap, and the NaN slab false-miss for axis-aligned
rays on exact block-bound planes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest


def test_site_layout_never_collides():
    """Alpha-walk sites 2+k must stay strictly below the bounce's GGX/RR
    sites for ANY walk depth, and the stride must cover every site."""
    from path_tracer_tpu.ops import rng

    for steps in (1, 8, 38, 39, 55, 200):
        g1, g2, srr, stride = rng.site_layout(steps)
        walk_sites = set(rng.SITE_ALPHA + k for k in range(steps))
        assert not walk_sites & {g1, g2, srr}, steps
        assert max(walk_sites | {g1, g2, srr}) < stride, steps
    # Shallow walks keep the historical constants (frozen goldens depend
    # on the exact streams).
    assert rng.site_layout(38) == (rng.SITE_GGX_R1, rng.SITE_GGX_R2,
                                   rng.SITE_RR, rng.SITE_STRIDE)


def test_deep_walk_alpha_draw_differs_from_ggx():
    """At walk depths beyond the historical layout, the alpha-accept
    uniform must not equal the same bounce's GGX r1 draw (the collision
    the widened layout exists to prevent)."""
    from path_tracer_tpu.ops import rng

    steps = 55
    g1, _, _, stride = rng.site_layout(steps)
    pix = jnp.arange(64, dtype=jnp.int32)
    for bounce in (0, 1, 3):
        k = 38  # the first colliding step under the OLD 64-stride layout
        a = rng.uniform(pix, 1, rng.SITE_ALPHA + k + stride * bounce, 0)
        g = rng.uniform(pix, 1, g1 + stride * bounce, 0)
        assert not np.allclose(np.asarray(a), np.asarray(g))


def test_apply_params_rebakes_material_rows():
    """Forward renders (differentiable=False) read BAKED sl_attr factor
    columns; apply_params must refresh them so a fitted scene renders with
    the updated materials."""
    from path_tracer_tpu.models.integrator import IntegratorSpec, render_wavefront
    from path_tracer_tpu.parallel.train import apply_params, get_params
    from path_tracer_tpu.scene.procedural import cornell_device_scene

    scene = cornell_device_scene()
    assert scene.use_bvh or scene.sl_n_blocks >= 0  # baked rows exist
    params = get_params(scene)
    params = dict(params)
    params["mat_albedo_factor"] = params["mat_albedo_factor"] * 0.25
    updated = apply_params(scene, params)

    from path_tracer_tpu.scene.device_scene import ATTR_ALBEDO_F

    rows = np.asarray(updated.sl_attr[:, ATTR_ALBEDO_F:ATTR_ALBEDO_F + 3])
    mid = np.asarray(updated.sl_attr[:, 27]).astype(np.int32)
    want = np.asarray(updated.mat_albedo_factor)[mid]
    np.testing.assert_allclose(rows, want, rtol=1e-6)

    # End-to-end: the forward (non-differentiable) render must change.
    spec = IntegratorSpec(bounces=1, differentiable=False,
                          alpha_walk_steps=2, shadow_walk_steps=2)
    pix = jnp.arange(64, dtype=jnp.int32)
    before = np.asarray(render_wavefront(scene, pix, 8, 8, jnp.int32(1), spec))
    after = np.asarray(render_wavefront(updated, pix, 8, 8, jnp.int32(1), spec))
    assert not np.allclose(before, after)


def test_profile_null_int_rejected():
    from path_tracer_tpu.config import Profile

    with pytest.raises(ValueError, match="bounces"):
        Profile.from_dict({"bounces": None})
    # Walk depths are documented-nullable (null = auto-size from the scene).
    p = Profile.from_dict({"alpha_walk_steps": None})
    assert p.alpha_walk_steps is None


def test_rebalance_rejects_indivisible_wavefront():
    from path_tracer_tpu.parallel.render import _alive_first_all_to_all

    exchange = _alive_first_all_to_all("dp", 8)
    state = tuple(jnp.zeros((10, 3)) for _ in range(4)) + (
        jnp.ones((10,), jnp.bool_), jnp.arange(10, dtype=jnp.int32),
        jnp.arange(10, dtype=jnp.int32))
    with pytest.raises(ValueError, match="divisible"):
        # eval_shape traces without a real mesh; the check fires first.
        jax.eval_shape(exchange, state)


def test_axis_aligned_ray_on_block_plane_hits():
    """A ray with a zero direction component whose origin lies EXACTLY on a
    box-bound plane must still hit (1/d = inf poisons the slab test with
    0 * inf = NaN, which must not silently drop the box)."""
    from path_tracer_tpu.ops.bvh_triton import (
        closest_hit_triangles_kernel,
        occluded_triangles_kernel,
    )
    from path_tracer_tpu.ops.intersect import closest_hit_triangles
    from path_tracer_tpu.scene import isf
    from path_tracer_tpu.scene.device_scene import build_device_scene

    # One unit quad in the z=0 plane; its block bounds have min.y == 0.
    def v(x, y, uv):
        return isf.Vertex(position=(x, y, 0.0), normal=(0, 0, 1),
                          tex_coords=uv)

    mesh = isf.Mesh(
        triangles=[
            (v(0, 0, (0, 0)), v(1, 0, (1, 0)), v(1, 1, (1, 1))),
            (v(0, 0, (0, 0)), v(1, 1, (1, 1)), v(0, 1, (0, 1))),
        ],
        material=isf.Material(
            albedo=isf.Channel3(), emissive=isf.Channel3(factor=(0, 0, 0)),
            opacity=isf.Channel1(), metalness=isf.Channel1(factor=0.0),
            roughness=isf.Channel1()),
    )
    cam = isf.Camera(
        transform=[[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 5, 1]],
        fov=0.7, zfar=100, znear=0.01)
    scene = isf.Scene(
        models=[mesh], camera=cam,
        lights=[isf.PointLight(position=(0.5, 0.5, 2.0), color=(1, 1, 1))],
        background=(0, 0, 0))
    dev = build_device_scene(scene, root=".", use_bvh=True)

    # Origin exactly on the block's y=0 bound plane, dy == 0, aims at the quad.
    o = jnp.asarray([[0.5, 0.0, 1.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    tp = jnp.full((1,), -1.0, jnp.float32)

    ref = closest_hit_triangles(o, d, tp, dev, block=dev.sl_block)
    got = closest_hit_triangles_kernel(o, d, tp, dev, interpret=True)
    assert bool(np.asarray(ref.kind)[0] > 0), "brute reference must hit"
    assert bool(np.asarray(got.kind)[0] > 0), "BVH kernel dropped the box"
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=1e-5)

    occ = occluded_triangles_kernel(o, d, jnp.asarray([2.0], jnp.float32),
                                    dev, interpret=True)
    assert bool(np.asarray(occ)[0]), "any-hit kernel dropped the box"
