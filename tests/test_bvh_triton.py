"""The GPU BVH kernels (ops/bvh_triton.py) on the CPU.

The kernels run here in Pallas interpret mode: the same kernel body, block
by block, checked against the jnp BVH walk (ops/bvh_traverse.py) and the
brute-force scan (ops/intersect.py). kind/prim must match exactly; t, u, v
to the rounding the two lowerings may differ by. Their Triton lowering for
CUDA is also built here (no GPU needed), which catches primitives the
route cannot lower. Every case keeps to <= 1024 rays; the ray counts are
not multiples of the 128-ray block, so the padding path always runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from path_tracer_tpu.ops import bvh_triton
from path_tracer_tpu.ops.bvh_traverse import closest_hit_triangles_bvh
from path_tracer_tpu.ops.intersect import closest_hit_triangles

SCENES = ("head", "cornell", "showcase")


@pytest.fixture(scope="module")
def scenes(reference_scenes):
    from path_tracer_tpu.scene import load_scene
    from path_tracer_tpu.scene.procedural import cornell_device_scene
    from path_tracer_tpu.scene.showcase import showcase_device_scene

    return {
        "head": dataclasses.replace(
            load_scene(reference_scenes / "head" / "scene.isf"),
            use_bvh=True),
        "cornell": dataclasses.replace(cornell_device_scene(), use_bvh=True),
        "showcase": showcase_device_scene(grid=32, use_bvh=True),
    }


def _rays(scene, r, seed):
    """Rays from around the scene's bounds toward points inside it."""
    rng = np.random.default_rng(seed)
    v0 = np.asarray(scene.tri_v0)[: scene.num_real_triangles]
    lo, hi = v0.min(axis=0), v0.max(axis=0)
    span = np.maximum(hi - lo, 1e-3)
    o = rng.uniform(lo - 0.5 * span, hi + 0.5 * span, (r, 3))
    tgt = rng.uniform(lo, hi, (r, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def _kernel_closest(o, d, tp, s):
    return bvh_triton.closest_hit_triangles_kernel(o, d, tp, s,
                                                   interpret=True)


def _kernel_occluded(o, d, tm, s):
    return bvh_triton.occluded_triangles_kernel(o, d, tm, s, interpret=True)


@pytest.mark.parametrize("t_prev", [-1.0, 0.5])
@pytest.mark.parametrize("name", SCENES)
def test_closest_hit_kernel_matches_walks(scenes, name, t_prev):
    s = scenes[name]
    r = 1000
    o, d = _rays(s, r, 11)
    tp = jnp.full((r,), t_prev, jnp.float32)
    got = jax.jit(_kernel_closest)(o, d, tp, s)
    walk = jax.jit(closest_hit_triangles_bvh)(o, d, tp, s)
    brute = jax.jit(closest_hit_triangles)(o, d, tp, s)
    assert float(jnp.mean(walk.valid)) > 0.3
    for ref in (walk, brute):
        np.testing.assert_array_equal(np.asarray(got.kind),
                                      np.asarray(ref.kind))
        np.testing.assert_array_equal(np.asarray(got.prim),
                                      np.asarray(ref.prim))
        np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                                   rtol=1e-6)
        # Barycentrics in [0, 1]: absolute tolerance (u = (tvec.pvec)/det
        # cancels, so ulps of the far-from-origin operands show here).
        np.testing.assert_allclose(np.asarray(got.u), np.asarray(ref.u),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(got.v), np.asarray(ref.v),
                                   atol=1e-5)
        np.testing.assert_array_equal(np.asarray(got.backface),
                                      np.asarray(ref.backface))
    assert (np.asarray(got.packed) == -1).all()


@pytest.mark.parametrize("t_max_kind", ["finite", "inf", "dead"])
@pytest.mark.parametrize("name", SCENES)
def test_anyhit_kernel_matches_nearest_in_range(scenes, name, t_max_kind):
    """Any hit within t_max == the nearest hit lies within t_max. Finite
    limits sit at half the nearest hit's t on odd lanes (must NOT occlude)
    and beyond it on even lanes; -1 marks a dead lane."""
    s = scenes[name]
    r = 1000
    o, d = _rays(s, r, 5)
    near = closest_hit_triangles_bvh(o, d, jnp.full((r,), -1.0), s)
    lane = jnp.arange(r)
    if t_max_kind == "finite":
        tm = jnp.where(jnp.isfinite(near.t),
                       jnp.where(lane % 2 == 0, near.t * 1.5, near.t * 0.5),
                       10.0)
    elif t_max_kind == "inf":
        tm = jnp.full((r,), jnp.inf, jnp.float32)
    else:
        tm = jnp.where(lane % 3 == 0, -1.0, jnp.inf).astype(jnp.float32)
    got = np.asarray(jax.jit(_kernel_occluded)(o, d, tm, s))
    want = np.asarray(near.valid & (near.t <= tm))
    np.testing.assert_array_equal(got, want)
    if t_max_kind == "dead":
        assert not got[::3].any()
    assert want.any()


@pytest.mark.parametrize("r", [1, 127, 129])
def test_kernel_pads_to_block_and_slices_back(scenes, r):
    s = scenes["cornell"]
    o, d = _rays(s, r, 2)
    hit = _kernel_closest(o, d, jnp.full((r,), -1.0), s)
    assert all(f.shape == (r,) for f in hit)
    assert hit.backface.dtype == jnp.bool_
    occ = _kernel_occluded(o, d, jnp.full((r,), jnp.inf), s)
    assert occ.shape == (r,) and occ.dtype == jnp.bool_
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(hit.valid))


@pytest.mark.parametrize("which", ["closest", "anyhit"])
def test_kernel_lowers_to_triton_for_cuda(scenes, which):
    """Build the kernels' Triton lowering for CUDA on this host: the
    pallas_call must lower through the Triton route with every primitive it
    uses (integer-array loads, masked loads, while_loop, bitwise ops)."""
    s = scenes["showcase"]
    r = 300
    o, d = _rays(s, r, 1)
    lim = jnp.full((r,), -1.0 if which == "closest" else jnp.inf)
    fn = (bvh_triton.closest_hit_triangles_kernel if which == "closest"
          else bvh_triton.occluded_triangles_kernel)
    text = jax.jit(fn).trace(o, d, lim, s).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert f"bvh_{'closest' if which == 'closest' else 'anyhit'}" in text
