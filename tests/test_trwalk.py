"""Transparent-walk tables and the XLA transparent walks in training mode.

The partitioned walks come in two value-identical forms: the DENSE column
walk (default on the CPU) and the chunked per-iteration CAST walk
(PT_NO_DENSE_TR=1, the GPU default). These tests pin that both read the
LIVE opacity factors and textures a train step may replace, and that the
transparent-walk tables the scene builder produces are consistent.
Near-tie reorderings between the two forms are measure-zero, so the gates
bound a divergence rate instead of asserting exact equality.
"""
import numpy as np
import pytest
import jax.numpy as jnp

from path_tracer_tpu.models.integrator import IntegratorSpec, render_wavefront


@pytest.fixture(scope="module")
def tex_scene():
    from path_tracer_tpu.scene.showcase import showcase_device_scene

    return showcase_device_scene(grid=48, textured=True)


def test_tables_built(tex_scene):
    s = tex_scene
    assert s.tr_kernel_ok and s.tr_textured
    n_tr = s.num_real_triangles - s.n_tris_opaque
    # Compact columns: exactly the real transparent triangles + 128-pad
    # (minimum 256).
    assert s.tr_bw.shape[1] == max(256, ((n_tr + 127) // 128) * 128)
    # colmap points into the transparent slot range and at real slots.
    cm = np.asarray(s.tr_colmap)[:n_tr]
    assert (cm >= s.sl_n_blocks_opaque * s.sl_block).all()
    sl_map = np.asarray(s.sl_map)
    assert (sl_map[cm] >= s.n_tris_opaque).all()
    # The u8 texture page plane + LUT reproduce the atlas bit-for-bit.
    lut = np.asarray(s.tr_lut)[0]
    assert len(s.tr_pages) == 1
    off, w, h, yb = s.tr_pages[0]
    t8 = np.asarray(s.tr_tex8, np.float32)[yb : yb + h, :w]
    plane = np.asarray(s.tex_data)[off : off + w * h, 0].reshape(h, w)
    assert np.array_equal(lut[t8.astype(np.int32)], plane)


def _dense_and_cast(monkeypatch, fn):
    """(dense-walk result, cast-walk result) of fn()."""
    monkeypatch.delenv("PT_NO_DENSE_TR", raising=False)
    a = fn()
    monkeypatch.setenv("PT_NO_DENSE_TR", "1")
    b = fn()
    monkeypatch.delenv("PT_NO_DENSE_TR")
    return a, b


def test_differentiable_mode_live_opacity_factor(tex_scene, monkeypatch):
    """Training mode: the walks must read the LIVE opacity-factor table (a
    train step may dataclasses.replace it). Both walk forms agree on the
    replaced factor, and the change shows in the image."""
    import dataclasses

    from path_tracer_tpu.models import integrator as I

    W, H = 32, 24
    ids = jnp.arange(W * H, dtype=jnp.int32)
    spec = IntegratorSpec(bounces=2)  # differentiable=True
    s2 = dataclasses.replace(
        tex_scene, mat_opacity_factor=tex_scene.mat_opacity_factor * 0.6)
    assert I._use_dense_tr(s2)
    a, b = _dense_and_cast(monkeypatch, lambda: np.asarray(
        render_wavefront(s2, ids, W, H, jnp.int32(1), spec)))
    d = np.abs(a - b)
    assert (d.max(axis=-1) > 1e-3).mean() < 0.005, d.max()
    # And the factor change actually mattered (the live row was read).
    c = np.asarray(render_wavefront(tex_scene, ids, W, H, jnp.int32(1),
                                    spec))
    assert np.abs(a - c).max() > 1e-3


def test_differentiable_mode_gradients(tex_scene, monkeypatch):
    """jax.grad through the render (walks detached): the shading gradient
    is the same through the dense and the cast walk."""
    import dataclasses
    import jax

    W, H = 24, 16
    ids = jnp.arange(W * H, dtype=jnp.int32)
    spec = IntegratorSpec(bounces=1, alpha_walk_steps=3,
                          shadow_walk_steps=3)

    def loss(f):
        s2 = dataclasses.replace(
            tex_scene, mat_albedo_factor=tex_scene.mat_albedo_factor * f)
        return jnp.mean(render_wavefront(s2, ids, W, H, jnp.int32(1), spec))

    g_dense, g_cast = _dense_and_cast(
        monkeypatch, lambda: float(jax.grad(loss)(jnp.float32(1.0))))
    assert np.isfinite(g_dense) and abs(g_cast) > 1e-9
    assert abs(g_dense - g_cast) <= 0.02 * abs(g_cast) + 1e-7


@pytest.fixture(scope="module")
def two_tex_scene(tmp_path_factory):
    """Opaque floor + two stacks of transparent quads, each stack sampling
    a DIFFERENT opacity texture (plus one factor-only quad) — multi-page
    transparent-walk tables (ref material.rs:115-130 fetches opacity from
    ANY per-material texture)."""
    from path_tracer_tpu.scene import isf
    from path_tracer_tpu.scene.device_scene import build_device_scene
    from path_tracer_tpu.scene.procedural import _camera, _mat, _quad
    from path_tracer_tpu.utils.image_io import save_png

    root = tmp_path_factory.mktemp("two_tex")
    rng = np.random.default_rng(7)
    # Distinct sizes so the pages exercise per-page index math.
    for name, size in (("op_a.png", 32), ("op_b.png", 48)):
        u8 = rng.integers(0, 256, (size, size), dtype=np.uint8)
        save_png(u8, root / name)

    def tex_mat(tex):
        m = _mat(albedo=(0.4, 0.6, 0.5))
        return isf.Material(
            albedo=m.albedo, emissive=m.emissive,
            opacity=isf.Channel1(factor=1.0, texture=tex),
            metalness=m.metalness, roughness=m.roughness)

    models = [isf.Mesh(
        triangles=_quad((-8, 0, 8), (8, 0, 8), (8, 0, -8), (-8, 0, -8),
                        (0, 1, 0)),
        material=_mat(albedo=(0.7, 0.7, 0.7)))]
    for i, (x, tex) in enumerate((( -2.0, "op_a.png"), (2.0, "op_b.png"))):
        for k in range(3):
            z = -1.0 - 1.2 * k
            models.append(isf.Mesh(
                triangles=_quad((x - 1.5, 0.2, z), (x + 1.5, 0.2, z),
                                (x + 1.5, 2.6, z), (x - 1.5, 2.6, z),
                                (0, 0, 1)),
                material=tex_mat(tex)))
    models.append(isf.Mesh(  # factor-only transparent quad between stacks
        # z = -2.8 keeps it NON-coplanar with the stack quads (z = -1.0,
        # -2.2, -3.4): a coplanar overlap makes exact-t duplicate
        # candidates whose strict-advance skip is formula-dependent
        # (BW vs MT ulp ties) — systematic divergence, not the
        # measure-zero class the parity gates bound.
        triangles=_quad((-1.0, 0.2, -2.8), (1.0, 0.2, -2.8),
                        (1.0, 2.6, -2.8), (-1.0, 2.6, -2.8), (0, 0, 1)),
        material=_mat(albedo=(0.8, 0.3, 0.3), opacity=0.45)))
    scene = isf.Scene(
        models=models,
        camera=_camera(pos=(0.0, 2.0, 7.0), fov_deg=60.0),
        lights=[isf.DirectionalLight(direction=(0.3, -1.0, -0.4),
                                     color=(2.0, 2.0, 2.0)),
                isf.PointLight(position=(0.0, 6.0, 2.0),
                               color=(900.0, 900.0, 900.0))],
        background=(0.2, 0.3, 0.5),
    )
    return build_device_scene(scene, root=str(root), use_bvh=True)


def test_multi_texture_pages_built(two_tex_scene):
    s = two_tex_scene
    assert s.tr_kernel_ok and s.tr_textured
    assert len(s.tr_pages) == 2
    lut = np.asarray(s.tr_lut)[0]
    t8 = np.asarray(s.tr_tex8, np.float32)
    for off, w, h, yb in s.tr_pages:
        plane = np.asarray(s.tex_data)[off : off + w * h, 0].reshape(h, w)
        assert np.array_equal(lut[t8[yb : yb + h, :w].astype(np.int32)],
                              plane)
    # Per-column page indices point at the column's own opacity texture.
    n_tr = s.num_real_triangles - s.n_tris_opaque
    rows = np.asarray(s.tr_rows)
    models = np.asarray(s.tr_model)[:n_tr]
    tids = np.asarray(s.mat_opacity_tex)[models]
    page_tid = {p: off for p, (off, w, h, yb) in enumerate(s.tr_pages)}
    offsets = np.asarray(s.tex_offset)
    for c in range(n_tr):
        if rows[7, c] > 0:
            assert page_tid[int(rows[8, c])] == offsets[tids[c]]


def test_training_updates_opacity_texture(two_tex_scene, monkeypatch):
    """Two train steps that move an OPACITY TEXTURE: the training-mode
    forward must track the live texture through both walk forms."""
    import dataclasses

    s = two_tex_scene
    W, H = 32, 24
    ids = jnp.arange(W * H, dtype=jnp.int32)
    spec = IntegratorSpec(bounces=2)  # differentiable=True (training mode)
    # Simulate 2 train steps perturbing the first opacity texture's texels
    # (values in (0,1) keep the stochastic-accept branch live).
    off, w, h, yb = s.tr_pages[0]
    td = s.tex_data
    for step in (0.17, -0.09):
        upd = jnp.clip(td[off : off + w * h] + step, 0.05, 0.95)
        td = td.at[off : off + w * h].set(upd)
    s2 = dataclasses.replace(s, tex_data=td)

    a, b = _dense_and_cast(monkeypatch, lambda: np.asarray(
        render_wavefront(s2, ids, W, H, jnp.int32(1), spec)))
    d = np.abs(a - b)
    assert (d.max(axis=-1) > 1e-3).mean() < 0.005, d.max()
    assert d.mean() < 1e-5
    # And the texture change actually changed the image (the live atlas
    # was read, not the build-time snapshot).
    c = np.asarray(render_wavefront(s, ids, W, H, jnp.int32(1), spec))
    assert np.abs(a - c).max() > 1e-3


def test_refresh_baked_textures(two_tex_scene):
    """Post-training export path: refresh_baked_textures rebuilds the baked
    texel tables (tex_wide, tr_tex8) from the live atlas, so FORWARD
    rendering of a fitted scene (baked rows) matches the training-mode
    render (live atlas); off-u8-grid texels clear tr_kernel_ok instead of
    silently quantizing."""
    import dataclasses
    from path_tracer_tpu.parallel.train import refresh_baked_textures

    s = two_tex_scene
    off, w, h, yb = s.tr_pages[0]
    lut = np.asarray(s.tr_lut)[0]

    # u8-grid-preserving update: invert the first page's texels.
    plane = np.asarray(s.tex_data[off : off + w * h, 0])
    inv_u8 = 255 - np.round(plane * 255).astype(np.int32)
    upd = jnp.asarray(np.repeat(lut[inv_u8][:, None], 3, axis=1))
    s2 = refresh_baked_textures(dataclasses.replace(
        s, tex_data=s.tex_data.at[off : off + w * h].set(upd)))
    assert s2.tr_kernel_ok
    t8 = np.asarray(s2.tr_tex8, np.float32)[yb : yb + h, :w]
    assert np.array_equal(t8.astype(np.int32).reshape(-1), inv_u8)
    # Forward (baked-rows) render of the refreshed scene equals the
    # training-mode (live-atlas) render of the same scene.
    W, H = 32, 24
    ids = jnp.arange(W * H, dtype=jnp.int32)
    a = np.asarray(render_wavefront(
        s2, ids, W, H, jnp.int32(1),
        IntegratorSpec(bounces=2, differentiable=False)))
    b = np.asarray(render_wavefront(s2, ids, W, H, jnp.int32(1),
                                    IntegratorSpec(bounces=2)))
    d = np.abs(a - b)
    assert (d.max(axis=-1) > 1e-3).mean() < 0.005, d.max()
    # tex_wide refreshed too (opacity rides the wide table on this scene).
    if any(s2.wide_covered):
        assert not np.array_equal(np.asarray(s2.tex_wide),
                                  np.asarray(s.tex_wide))

    # Off-grid update (generic gradient step): the u8 tables are invalid.
    s3 = refresh_baked_textures(dataclasses.replace(
        s, tex_data=s.tex_data.at[off : off + w * h].set(
            jnp.clip(s.tex_data[off : off + w * h] + 0.123, 0.0, 1.0))))
    assert not s3.tr_kernel_ok
