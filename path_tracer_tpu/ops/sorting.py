"""Wavefront ray sorting for traversal coherence.

The GPU BVH kernel (ops/bvh_triton.py) walks one ray per lane, and a block of
lanes runs until its slowest lane exits, so its cost follows the divergence
of the rays within a block. Camera wavefronts are naturally coherent (adjacent pixel ids); bounce and
shadow wavefronts are not. Sorting rays by a (origin-cell, direction-octant)
Morton key before the cast groups similar rays into the same tile — the
classic wavefront-tracer compaction step (SURVEY §5 "long-context" analog) —
and an inverse permutation scatters results back.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp


def _part1by2(x):
    """Spread 10 bits of x over 30 (Morton interleave helper)."""
    x = x.astype(jnp.uint32) & 0x3FF
    x = (x | (x << 16)) & jnp.uint32(0x030000FF)
    x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x09249249)
    return x


def morton3(ix, iy, iz):
    return _part1by2(ix) | (_part1by2(iy) << 1) | (_part1by2(iz) << 2)


def ray_sort_keys(o, d, bbox_lo, bbox_hi, origin_bits: int = 5,
                  dir_bits: int = 3):
    """uint32 sort keys: origin Morton (high) | direction Morton (low).

    o, d: [R,3]. Origins quantize against the scene bbox; directions against
    [-1,1]. Rays from the same region with similar directions sort together.
    """
    span = jnp.maximum(bbox_hi - bbox_lo, 1e-6)
    oq = jnp.clip((o - bbox_lo) / span, 0.0, 1.0)
    scale_o = float((1 << origin_bits) - 1)
    io = (oq * scale_o).astype(jnp.uint32)
    mo = morton3(io[:, 0], io[:, 1], io[:, 2])  # 3*origin_bits bits

    dq = jnp.clip((d + 1.0) * 0.5, 0.0, 1.0)
    scale_d = float((1 << dir_bits) - 1)
    idir = (dq * scale_d).astype(jnp.uint32)
    md = morton3(idir[:, 0], idir[:, 1], idir[:, 2])  # 3*dir_bits bits

    return (mo << (3 * dir_bits)) | md


def sort_permutation(keys):
    """(perm, inv_perm): x[perm] sorts by key; y[inv_perm] undoes it."""
    perm = jnp.argsort(keys)
    inv = jnp.argsort(perm)
    return perm, inv


def morton_pixel_order(width: int, height: int, tile: int = 16):
    """HOST-side coherent pixel ordering [W*H] (numpy int32, read-only).

    Pixels grouped into tile x tile screen blocks (tile-major, raster within
    the block): a 256-lane packet then covers a 16x16 screen square instead
    of a 256x1 scanline strip, so neighbouring lanes trace neighbouring
    rays, and the renderer feeds wavefronts in this order instead of
    sorting rays on the device.

    Cached per (width, height, tile): the 1080p argsort is host work that
    would otherwise repeat on every render call.
    """
    return _morton_pixel_order_cached(width, height, tile)


@functools.lru_cache(maxsize=8)
def _morton_pixel_order_cached(width: int, height: int, tile: int):
    import numpy as np

    ids = np.arange(width * height, dtype=np.int64)
    x = ids % width
    y = ids // width
    key = ((y // tile).astype(np.int64) << 40) \
        | ((x // tile).astype(np.int64) << 20) \
        | ((y % tile) << 10) | (x % tile)
    out = ids[np.argsort(key, kind="stable")].astype(np.int32)
    out.flags.writeable = False  # cached: callers must copy to mutate
    return out
