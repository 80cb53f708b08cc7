"""Sphere block tables (scene/device_scene._sphere_blocks): every real
sphere sits in exactly one block, and each block's AABB bounds its spheres.
"""
import numpy as np


def test_sphere_block_tables_invariants():
    """Sphere block-walk build (device_scene._sphere_blocks): every real
    sphere lands in exactly one block slot, the map restores the original
    id, block AABBs cover their spheres, and pad slots are guaranteed
    misses."""
    from path_tracer_tpu.scene.procedural import sphere_grid_device_scene

    s = sphere_grid_device_scene(70)
    assert s.sph_use_blocks
    packed = np.asarray(s.sph_sorted_t)
    smap = np.asarray(s.sph_smap)
    blk = np.asarray(s.sph_blk)
    blkid = np.asarray(s.sph_blkid)[0]
    centers = np.asarray(s.sph_center)[: s.num_real_spheres]
    radii = np.asarray(s.sph_radius)[: s.num_real_spheres]
    real = packed[3] > 0.0  # pad slots have radius 0
    assert real.sum() == s.num_real_spheres
    # Bijection real slots <-> original ids, with matching geometry.
    ids = smap[real]
    assert sorted(ids.tolist()) == list(range(s.num_real_spheres))
    np.testing.assert_array_equal(packed[0:3, real].T, centers[ids])
    np.testing.assert_array_equal(packed[3, real], radii[ids])
    # Per-block AABBs cover their spheres.
    nblk = int((blkid >= 0).max()) + 1
    for b in range(nblk):
        sl = slice(b * 128, (b + 1) * 128)
        rb = real[sl]
        if not rb.any():
            continue
        c = packed[0:3, sl][:, rb].T
        r = packed[3, sl][rb]
        assert (c - r[:, None] >= blk[0:3, b] - 1e-4).all()
        assert (c + r[:, None] <= blk[3:6, b] + 1e-4).all()
