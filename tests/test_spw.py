"""Samples-per-wavefront packing parity (renderer.py _accumulate_tile spw).

spw packs each pixel spw times into a kernel packet with consecutive
per-lane sample ids, shrinking the packet's screen footprint. The
per-(pixel, sample) RNG streams must be
IDENTICAL to the spw=1 schedule — only float accumulation order may differ,
so the pixel sums must match to addition-reorder tolerance.
"""
import numpy as np
import pytest


def _tile_sums(scene, W, H, ids_pix, n_samples, spec, spw):
    import jax.numpy as jnp

    from path_tracer_tpu.models.renderer import _accumulate_tile
    from path_tracer_tpu.models.renderer import RAY_TILE

    if spw == 1:
        lanes = ids_pix
        acc = jnp.zeros((lanes.shape[0], 3), jnp.float32)
    else:
        sb = RAY_TILE // spw
        lanes = np.repeat(ids_pix.reshape(-1, 1, sb), spw, axis=1).reshape(-1)
        acc = jnp.zeros((ids_pix.shape[0], 3), jnp.float32)
    out = _accumulate_tile(acc, scene, jnp.asarray(lanes), W, H,
                           jnp.int32(1), n_samples, spec, spw=spw)
    return np.asarray(out)


@pytest.mark.parametrize("name", ["spheres", "head", "alpha_transparency"])
@pytest.mark.parametrize("spw", [2, 4])
def test_spw_matches_unpacked(reference_scenes, name, spw):
    from path_tracer_tpu.models.integrator import IntegratorSpec
    from path_tracer_tpu.models.renderer import RAY_TILE
    from path_tracer_tpu.scene import load_scene

    scene = load_scene(reference_scenes / name / "scene.isf")
    W, H = 32, 24
    n_pix = W * H
    spec = IntegratorSpec(bounces=3, alpha_walk_steps=4, shadow_walk_steps=4)
    ids = np.arange(2 * RAY_TILE, dtype=np.int32) % n_pix  # 2 packets

    # base: every lane is a distinct pixel, accumulating samples 1..spw over
    # spw scan steps. packed: the first 2*RAY_TILE/spw of those pixels, all
    # spw samples in ONE wavefront. Identical (pixel, sample) radiance
    # terms — only the addition order differs.
    base = _tile_sums(scene, W, H, ids, spw, spec, spw=1)
    packed = _tile_sums(scene, W, H, ids[: 2 * RAY_TILE // spw],
                        spw, spec, spw=spw)
    np.testing.assert_allclose(packed, base[: packed.shape[0]],
                               rtol=2e-5, atol=2e-6)


def test_render_pixel_sums_spw_fallback_multidevice(reference_scenes):
    """On the 8-device test mesh the spw path must fall back loudly and
    still produce the spw=1 result (render_pixel_sums guard)."""
    import jax

    from path_tracer_tpu.models.integrator import IntegratorSpec
    from path_tracer_tpu.models.renderer import render_pixel_sums
    from path_tracer_tpu.scene import load_scene

    if len(jax.devices()) == 1:
        pytest.skip("needs the multi-device mesh to exercise the fallback")
    scene = load_scene(reference_scenes / "spheres" / "scene.isf")
    spec = IntegratorSpec(bounces=2)
    a = render_pixel_sums(scene, 32, 24, 1, 2, spec, samples_per_launch=2)
    b = render_pixel_sums(scene, 32, 24, 1, 2, spec, samples_per_launch=2,
                          samples_per_wavefront=2)
    np.testing.assert_allclose(b, a, rtol=1e-6)
