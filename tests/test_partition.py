"""Opacity-partitioned traversal: views + integrator parity.

The partition (scene/device_scene.py: triangles stored [opaque..|
transparent..], per-partition BVHs concatenated as a skip-pointer forest /
128-aligned block-column ranges) lets the integrator replace the generic
sorted-hit walks with one opaque cast + a transparent-only walk
(ref mod.rs:188-205, 283-331 semantics preserved). These tests pin:

- the views cover the triangle set exactly (no overlap, no gap),
- subset casts against the views agree with the full-scene cast,
- the partitioned integrator matches the generic walk to fp-tie tolerance
  (different traversal order can flip shared-edge t ties),
- the GPU BVH kernel (Triton route, interpret mode) agrees on view tables.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from path_tracer_tpu.models.integrator import IntegratorSpec, render_wavefront
from path_tracer_tpu.scene.device_scene import (
    opaque_view,
    partitioned,
    transparent_view,
)


@pytest.fixture(scope="module")
def mixed_scene():
    from path_tracer_tpu.scene.showcase import showcase_device_scene

    return showcase_device_scene(grid=48, textured=True)


def _rays(scene, r, seed):
    rng = np.random.default_rng(seed)
    lo = np.asarray(scene.tri_v0[: scene.num_real_triangles]).min(axis=0)
    hi = np.asarray(scene.tri_v0[: scene.num_real_triangles]).max(axis=0)
    o = rng.uniform(lo - 4, hi + 4, (r, 3)).astype(np.float32)
    tgt = rng.uniform(lo, hi, (r, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_partition_gate(mixed_scene):
    from path_tracer_tpu.scene.procedural import cornell_device_scene

    assert partitioned(mixed_scene)
    assert not partitioned(cornell_device_scene())  # all-opaque: no split
    assert mixed_scene.n_tris_opaque > 0
    assert mixed_scene.n_tris_opaque < mixed_scene.num_real_triangles
    assert mixed_scene.sl_n_blocks_opaque > 0
    assert mixed_scene.sl_cols_opaque % 128 == 0


def test_views_partition_the_block_set(mixed_scene):
    s = mixed_scene
    ov, tv = opaque_view(s), transparent_view(s)
    op_ids = np.asarray(ov.sl_blkid[0])
    tr_ids = np.asarray(tv.sl_blkid[0])
    op_real = set(op_ids[op_ids >= 0].tolist())
    tr_real = set(tr_ids[tr_ids >= 0].tolist())
    assert op_real == set(range(s.sl_n_blocks_opaque))
    assert tr_real == set(range(s.sl_n_blocks_opaque, s.sl_n_blocks))
    # Every opaque-partition block contains only opaque-model triangles and
    # vice versa (sl_map slots of real rows, looked up via tri model).
    op_f = np.asarray(s.mat_opacity_factor)
    op_t = np.asarray(s.mat_opacity_tex)
    model = np.asarray(s.tri_model)
    sl_map = np.asarray(s.sl_map)
    attr = np.asarray(s.sl_attr)
    for b in range(s.sl_n_blocks):
        sl = slice(b * s.sl_block, (b + 1) * s.sl_block)
        # Real slots have nonzero MT edges (pad slots are all-zero rows —
        # their sl_map of 0 aliases prim 0 and must be excluded).
        real = np.abs(attr[sl, 3:9]).sum(axis=1) > 0
        rows = sl_map[sl][real]
        if not len(rows):
            continue
        m = model[rows]
        transparent = (op_f[m] < 1.0) | (op_t[m] >= 0)
        if b < s.sl_n_blocks_opaque:
            assert not transparent.any(), f"opaque block {b} has alpha tris"
        else:
            assert transparent.all(), f"transparent block {b} has opaque tris"


def test_subset_casts_compose_to_full(mixed_scene):
    """min(opaque-cast t, transparent-cast t) == full-cast t, per lane (CPU
    skip-pointer forest walk)."""
    from path_tracer_tpu.ops.bvh_traverse import closest_hit_triangles_bvh

    s = mixed_scene
    r = 512
    o, d = _rays(s, r, 5)
    tp = jnp.full((r,), -1.0, jnp.float32)
    full = closest_hit_triangles_bvh(o, d, tp, s)
    op = closest_hit_triangles_bvh(o, d, tp, opaque_view(s))
    tr = closest_hit_triangles_bvh(o, d, tp, transparent_view(s))
    t_min = np.minimum(np.asarray(op.t), np.asarray(tr.t))
    np.testing.assert_allclose(t_min, np.asarray(full.t), rtol=1e-6)
    # Partition purity: every opaque-cast hit is an opaque-range prim.
    hitm = np.isfinite(np.asarray(op.t))
    assert (np.asarray(op.prim)[hitm] < s.n_tris_opaque).all()
    hitt = np.isfinite(np.asarray(tr.t))
    assert (np.asarray(tr.prim)[hitt] >= s.n_tris_opaque).all()
    assert hitt.any() and hitm.any()


def test_flat_kernel_on_views_interpret(mixed_scene):
    """The GPU BVH kernel (interpret mode) walking a VIEW's tables (the
    opaque prefix of the forest, the transparent tree) matches the CPU
    forest walk on the same subset, closest hit and any hit."""
    from path_tracer_tpu.ops.bvh_traverse import closest_hit_triangles_bvh
    from path_tracer_tpu.ops.bvh_triton import (
        closest_hit_triangles_kernel,
        occluded_triangles_kernel,
    )

    s = mixed_scene
    r = 256
    o, d = _rays(s, r, 9)
    tp = jnp.full((r,), -1.0, jnp.float32)
    for view in (opaque_view(s), transparent_view(s)):
        ref = closest_hit_triangles_bvh(o, d, tp, view)
        got = closest_hit_triangles_kernel(o, d, tp, view, interpret=True)
        np.testing.assert_array_equal(np.asarray(got.prim),
                                      np.asarray(ref.prim))
        np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                                   rtol=5e-5, atol=1e-5)
        occ = occluded_triangles_kernel(
            o, d, jnp.full((r,), jnp.inf, jnp.float32), view,
            interpret=True)
        np.testing.assert_array_equal(np.asarray(occ),
                                      np.asarray(ref.valid))


def test_partitioned_render_matches_generic(mixed_scene, monkeypatch):
    """Full integrator: the partitioned walks reproduce the generic
    sorted-hit walks (same RNG sites, same visit order). Tolerance covers
    shared-edge t ties that flip with traversal order."""
    W, H = 64, 36
    ids = jnp.arange(W * H, dtype=jnp.int32)
    spec = IntegratorSpec(bounces=3, differentiable=False)
    assert partitioned(mixed_scene)
    a = np.asarray(render_wavefront(mixed_scene, ids, W, H, jnp.int32(1),
                                    spec))
    monkeypatch.setenv("PT_NO_PARTITION", "1")
    assert not partitioned(mixed_scene)
    b = np.asarray(render_wavefront(mixed_scene, ids, W, H, jnp.int32(1),
                                    spec))
    assert np.abs(a - b).max() <= 1e-4, np.abs(a - b).max()
    assert np.abs(a - b).mean() <= 1e-7


def test_partitioned_render_matches_generic_differentiable(mixed_scene,
                                                           monkeypatch):
    """Same parity through the differentiable path + its gradients."""
    import jax

    W, H = 24, 16
    ids = jnp.arange(W * H, dtype=jnp.int32)
    spec = IntegratorSpec(bounces=1, alpha_walk_steps=3, shadow_walk_steps=3)

    def loss(scene, f):
        import dataclasses

        s2 = dataclasses.replace(
            scene, mat_albedo_factor=scene.mat_albedo_factor * f)
        return jnp.mean(render_wavefront(s2, ids, W, H, jnp.int32(1), spec))

    la, ga = jax.value_and_grad(lambda f: loss(mixed_scene, f))(
        jnp.float32(1.0))
    monkeypatch.setenv("PT_NO_PARTITION", "1")
    lb, gb = jax.value_and_grad(lambda f: loss(mixed_scene, f))(
        jnp.float32(1.0))
    # Same fp-tie tolerance as the forward parity test: a shared-edge tie
    # flip moves a pixel by O(0.1), i.e. the 384-pixel mean by O(3e-4).
    assert abs(float(la) - float(lb)) <= 1e-4, (float(la), float(lb))
    assert abs(float(ga) - float(gb)) <= 1e-2 * max(1.0, abs(float(gb))), \
        (float(ga), float(gb))


def test_dense_residual_cast_fallback(mixed_scene, monkeypatch):
    """With the precompute cap forced to 1 column, walks deeper than one
    transparent hit continue through the cast residual. The handoff mixes
    two MT lowerings, so a last-ulp t difference at the boundary can
    re-visit/skip one hit (same class as the gated flat2 BW-vs-MT
    divergence) — bound the RATE and magnitude rather than demand bit
    parity (measured: max 1.5e-3, 0.2% of pixels > 1e-5). In real scenes
    the residual never runs (the K=6 default covers the measured max of 4
    productive crossings)."""
    W, H = 48, 32
    ids = jnp.arange(W * H, dtype=jnp.int32)
    spec = IntegratorSpec(bounces=2, differentiable=False)
    a = np.asarray(render_wavefront(mixed_scene, ids, W, H, jnp.int32(1),
                                    spec))
    monkeypatch.setenv("PT_DENSE_TR_K", "1")
    b = np.asarray(render_wavefront(mixed_scene, ids, W, H, jnp.int32(1),
                                    spec))
    d = np.abs(a - b)
    assert d.max() <= 1e-2, d.max()
    assert d.mean() <= 1e-5, d.mean()
    assert (d > 1e-5).mean() <= 1e-2, (d > 1e-5).mean()


def test_dense_tr_walk_matches_cast_walk(mixed_scene, monkeypatch):
    """The dense transparent-set walk (one fused MT matrix per chunk +
    argmin iterations — integrator._dense_tr_walker) is value-identical to
    the per-iteration transparent CAST walk it replaces: same strict
    t > t_prev advance, same MT math, same RNG sites. Unlike the
    partitioned-vs-generic test this one needs NO tie tolerance — both
    forms walk the same transparent subset in the same order."""
    from path_tracer_tpu.models.integrator import _use_dense_tr

    assert _use_dense_tr(mixed_scene)
    W, H = 64, 36
    ids = jnp.arange(W * H, dtype=jnp.int32)
    spec = IntegratorSpec(bounces=3, differentiable=False)
    a = np.asarray(render_wavefront(mixed_scene, ids, W, H, jnp.int32(1),
                                    spec))
    monkeypatch.setenv("PT_NO_DENSE_TR", "1")
    assert not _use_dense_tr(mixed_scene)
    b = np.asarray(render_wavefront(mixed_scene, ids, W, H, jnp.int32(1),
                                    spec))
    # The dense walker recomputes the selected hit's u/v per-ray (the matrix
    # pass keeps only t), so ~0.5% of pixels differ at the last-ulp level
    # (measured max 8e-8). A REAL divergence — a visit-order or RNG-site
    # flip — moves a pixel by O(0.1), so the max bound is the gate.
    diff = np.abs(a - b)
    assert diff.max() <= 1e-5, diff.max()
    assert diff.mean() <= 1e-7, diff.mean()


def test_flat2_on_partitioned_tables_interpret(mixed_scene):
    """The GPU BVH kernel (interpret mode) on the FULL partitioned forest:
    the walk crosses from the opaque tree into the transparent tree through
    the skip pointers, and prim ids stay global across the partition
    boundary."""
    from path_tracer_tpu.ops.bvh_traverse import closest_hit_triangles_bvh
    from path_tracer_tpu.ops.bvh_triton import closest_hit_triangles_kernel

    s = mixed_scene
    assert s.bvh_n_nodes > s.bvh_n_nodes_opaque  # a real forest
    r = 256
    o, d = _rays(s, r, 21)
    tp = jnp.full((r,), -1.0, jnp.float32)
    ref = closest_hit_triangles_bvh(o, d, tp, s)
    got = closest_hit_triangles_kernel(o, d, tp, s, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.prim), np.asarray(ref.prim))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=5e-5, atol=1e-5)
    # Some hits must land in the TRANSPARENT range for the forest to matter.
    hits = np.asarray(ref.prim)[np.isfinite(np.asarray(ref.t))]
    assert (hits >= s.n_tris_opaque).any()


@pytest.fixture(scope="module")
def many_cluster_scene():
    """46 transparent clusters scattered on a 500-unit plane + opaque floor:
    more clusters than the 32 tr_prefilter slots, so the overflow-union path
    (device_scene.py: leaves past 31 union into slot 31) is exercised."""
    from path_tracer_tpu.scene import isf
    from path_tracer_tpu.scene.device_scene import build_device_scene
    from path_tracer_tpu.scene.procedural import _camera, _mat, _quad

    rng = np.random.default_rng(3)
    models = [isf.Mesh(
        triangles=_quad((-260, 0, 260), (260, 0, 260), (260, 0, -260),
                        (-260, 0, -260), (0, 1, 0)),
        material=_mat(albedo=(0.6, 0.6, 0.6)))]
    for i in range(46):
        x, z = rng.uniform(-250, 250, 2)
        models.append(isf.Mesh(
            triangles=_quad((x - 1, 0.5, z), (x + 1, 0.5, z),
                            (x + 1, 2.5, z), (x - 1, 2.5, z), (0, 0, 1)),
            material=_mat(albedo=(0.2, 0.7, 0.3), opacity=0.4)))
    scene = isf.Scene(
        models=models,
        camera=_camera(pos=(0.0, 30.0, 300.0), fov_deg=70.0),
        lights=[isf.DirectionalLight(direction=(0.3, -1.0, -0.4),
                                     color=(2.0, 2.0, 2.0)),
                isf.PointLight(position=(0.0, 60.0, 0.0),
                               color=(9e4, 9e4, 9e4))],
        background=(0.2, 0.3, 0.5),
    )
    return build_device_scene(scene, root=".", use_bvh=True)


def test_prefilter_covers_all_transparent_tris_at_cap(many_cluster_scene):
    """With >32 scattered clusters the prefilter boxes must still cover
    EVERY transparent triangle (coverage completeness is what makes the
    prefilter conservative — a dropped cluster would silently skip walks
    and leak light through its foliage)."""
    s = many_cluster_scene
    assert partitioned(s)
    n_tr = s.num_real_triangles - s.n_tris_opaque
    assert n_tr == 92  # 46 quads
    boxes = np.asarray(s.tr_prefilter)
    real = boxes[boxes[:, 0] < 1e29]
    assert 2 <= len(real) <= 32
    v0 = np.asarray(s.tri_v0[s.n_tris_opaque:s.num_real_triangles])
    e1 = np.asarray(s.tri_e1[s.n_tris_opaque:s.num_real_triangles])
    e2 = np.asarray(s.tri_e2[s.n_tris_opaque:s.num_real_triangles])
    for verts in (v0, v0 + e1, v0 + e2):
        inside = ((verts[:, None, :] >= real[None, :, 0:3] - 1e-4)
                  & (verts[:, None, :] <= real[None, :, 3:6] + 1e-4))
        assert inside.all(axis=-1).any(axis=-1).all(), \
            "a transparent vertex is outside every prefilter box"


def test_many_cluster_render_matches_generic(many_cluster_scene, monkeypatch):
    """Full-integrator parity at the prefilter cap: the partitioned walks
    (with the 32-box prefilter active and slot 31 holding an overflow
    union) must reproduce the generic unpartitioned walk."""
    s = many_cluster_scene
    W, H = 64, 36
    ids = jnp.arange(W * H, dtype=jnp.int32)
    spec = IntegratorSpec(bounces=2, differentiable=False)
    assert partitioned(s)
    a = np.asarray(render_wavefront(s, ids, W, H, jnp.int32(1), spec))
    monkeypatch.setenv("PT_NO_PARTITION", "1")
    assert not partitioned(s)
    b = np.asarray(render_wavefront(s, ids, W, H, jnp.int32(1), spec))
    diff = np.abs(a - b)
    assert diff.max() <= 1e-4, diff.max()
    assert diff.mean() <= 1e-7, diff.mean()
