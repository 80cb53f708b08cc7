"""The one backend decision (ops.intersect.use_gpu_kernels).

"gpu" routes BVH scenes to the Triton kernels, compiled (interpret=False);
"cpu" routes them to the jnp walks and never calls a kernel; any other
backend is an error. The kernels are replaced by recorders here, so no GPU
is needed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from path_tracer_tpu.ops import bvh_triton, intersect


@pytest.fixture(scope="module")
def bvh_scene():
    from path_tracer_tpu.scene.procedural import cornell_device_scene

    return dataclasses.replace(cornell_device_scene(), use_bvh=True)


@pytest.fixture
def recorder(monkeypatch):
    """Replace both kernels with recorders that answer like the jnp walk."""
    from path_tracer_tpu.ops.bvh_traverse import closest_hit_triangles_bvh

    calls = []

    def closest(o, d, t_prev, scene, interpret=False):
        calls.append(("closest", interpret))
        return closest_hit_triangles_bvh(o, d, t_prev, scene)

    def occluded(o, d, t_max, scene, interpret=False):
        calls.append(("anyhit", interpret))
        hit = closest_hit_triangles_bvh(
            o, d, jnp.where(t_max < 0.0, jnp.inf, -1.0), scene)
        return hit.valid & (hit.t <= t_max)

    monkeypatch.setattr(bvh_triton, "closest_hit_triangles_kernel", closest)
    monkeypatch.setattr(bvh_triton, "occluded_triangles_kernel", occluded)
    return calls


def _rays(scene, r=64):
    """Rays from outside the scene's bounds toward points inside them."""
    rng = np.random.default_rng(0)
    v0 = np.asarray(scene.tri_v0)[: scene.num_real_triangles]
    lo, hi = v0.min(axis=0), v0.max(axis=0)
    o = rng.uniform(lo - (hi - lo), hi + (hi - lo), (r, 3))
    d = rng.uniform(lo, hi, (r, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


@pytest.mark.parametrize("query", ["closest", "anyhit"])
@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_backend_picks_kernel_or_jnp(bvh_scene, recorder, monkeypatch,
                                     backend, query):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert intersect.use_gpu_kernels() is (backend == "gpu")
    o, d = _rays(bvh_scene)
    r = o.shape[0]
    if query == "closest":
        hit = intersect.closest_hit(o, d, jnp.full((r,), -1.0), bvh_scene)
        assert hit.valid.any()
    else:
        intersect.occluded(o, d, bvh_scene)
    if backend == "gpu":
        assert recorder == [(query, False)]
    else:
        assert recorder == []


def test_unknown_backend_is_an_error(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        intersect.use_gpu_kernels()


def test_small_scenes_scan_on_every_backend(recorder, monkeypatch):
    """Scenes without a BVH take the brute-force scan, kernel or not."""
    from path_tracer_tpu.scene.procedural import cornell_device_scene

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    scene = cornell_device_scene()
    assert not scene.use_bvh
    o, d = _rays(scene)
    intersect.closest_hit(o, d, jnp.full((o.shape[0],), -1.0), scene)
    intersect.occluded(o, d, scene)
    assert recorder == []


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_dense_transparent_walk_on_every_backend(monkeypatch, backend):
    """The dense column walk serves small transparent partitions on both
    backends; the backend decides only the BVH walk."""
    from path_tracer_tpu.models import integrator
    from path_tracer_tpu.scene.showcase import showcase_device_scene

    scene = showcase_device_scene(grid=16, textured=True, use_bvh=True)
    monkeypatch.delenv("PT_NO_DENSE_TR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert integrator._use_dense_tr(scene)
    monkeypatch.setenv("PT_NO_DENSE_TR", "1")
    assert not integrator._use_dense_tr(scene)


def test_graft_entry_refuses_too_few_accelerators(monkeypatch):
    """__graft_entry__ never falls back to CPU devices on an accelerator."""
    import __graft_entry__ as entry

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(RuntimeError, match="need 64 gpu devices"):
        entry._ensure_devices(64)
