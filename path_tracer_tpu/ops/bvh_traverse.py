"""Stackless skip-pointer BVH traversal for a ray wavefront (pure jnp).

Replaces the reference's kdtree-ray traversal (ref: src/renderer/utils.rs:13,
src/scene/internal/model.rs:67-70) with the wavefront shape of the same idea: every
lane walks the flattened DFS node array with ``i`` (hit → i+1, miss/leaf →
skip[i]), inside one ``lax.while_loop`` that runs until every lane escapes.
Node and triangle data are packed into single rows so each step issues one
gather per table instead of six. This is the plain reference of the GPU
kernels in ops/bvh_triton.py, which walk the same tables.

Closest-hit semantics are identical to ops.intersect.closest_hit_triangles:
Möller-Trumbore with det cutoff 1e-6, t > max(1e-6, t_prev), no backface
culling (ref: src/scene/internal/triangle.rs:38-81). Subtrees are pruned
against the running best t (monotone shrink) and against t_prev (box exit
before t_prev cannot contain a valid hit).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from path_tracer_tpu.ops.intersect import (
    DET_EPS,
    KIND_NONE,
    KIND_TRIANGLE,
    T_MIN,
    HitRecord,
)

# bvh_nodes row layout: [mn.x mn.y mn.z mx.x mx.y mx.z skip(i32) leaf(i32)]
# where leaf = first_prim * 256 + prim_count (count <= leaf_size <= 255),
# both int32 bitcast into the f32 row so one gather fetches the whole node.


def pack_nodes(node_min, node_max, first_prim, prim_count, skip):
    """Host-side [N,8] f32 node table (see row layout above)."""
    import numpy as np

    n = node_min.shape[0]
    rows = np.empty((n, 8), np.float32)
    rows[:, 0:3] = node_min
    rows[:, 3:6] = node_max
    rows[:, 6] = skip.astype(np.int32).view(np.float32)
    leaf = (first_prim.astype(np.int32) << 8) | prim_count.astype(np.int32)
    rows[:, 7] = leaf.view(np.float32)
    return rows


def closest_hit_triangles_bvh(o, d, t_prev, scene) -> HitRecord:
    """Closest triangle hit with t > max(T_MIN, t_prev) via BVH traversal.

    o, d: [R,3]; t_prev: [R]. Uses scene.bvh_nodes [N,8] and scene.bvh_tris
    [M,9] (v0,e1,e2 packed; M padded so leaf windows never run off the end).
    """
    r = o.shape[0]
    n_nodes = scene.bvh_n_nodes  # real count; arrays are padded past it
    leaf_size = scene.bvh_leaf_size

    inv_d = 1.0 / d  # inf on zero components — IEEE slab test handles it

    def cond(state):
        i = state[0]
        return jnp.any(i < n_nodes)

    def body(state):
        i, bt, bi, bu, bv, bb = state
        i_safe = jnp.minimum(i, n_nodes - 1)
        node = scene.bvh_nodes[i_safe]  # [R,8] single gather
        mn = node[:, 0:3]
        mx = node[:, 3:6]
        skip = jax.lax.bitcast_convert_type(node[:, 6], jnp.int32)
        leaf = jax.lax.bitcast_convert_type(node[:, 7], jnp.int32)
        first = leaf >> 8
        count = leaf & 0xFF

        # Slab test (IEEE: 0*inf -> nan; min/max with nan propagate the
        # non-nan operand in jnp.minimum? No — use the robust ordering).
        t0 = (mn - o) * inv_d
        t1 = (mx - o) * inv_d
        tlo = jnp.minimum(t0, t1)
        thi = jnp.maximum(t0, t1)
        tn = jnp.max(jnp.where(jnp.isnan(tlo), -jnp.inf, tlo), axis=-1)
        tf = jnp.min(jnp.where(jnp.isnan(thi), jnp.inf, thi), axis=-1)
        active = i < n_nodes
        hit_box = active & (tf >= jnp.maximum(tn, 0.0)) & (tn <= bt) \
            & (tf > t_prev)

        is_leaf = count > 0
        leaf_active = hit_box & is_leaf

        # Test the leaf's prim window [first, first+leaf_size) lanes-wide.
        offs = jnp.arange(leaf_size, dtype=jnp.int32)
        prim_ids = first[:, None] + offs[None, :]  # [R,L]
        prim_mask = offs[None, :] < count[:, None]
        tri = scene.bvh_tris[prim_ids]  # [R,L,9] single gather
        v0 = tri[..., 0:3]
        e1 = tri[..., 3:6]
        e2 = tri[..., 6:9]

        ob = o[:, None, :]
        db = d[:, None, :]
        pvec = jnp.cross(db, e2)
        det = jnp.sum(e1 * pvec, axis=-1)  # [R,L]
        valid = prim_mask & leaf_active[:, None] & (jnp.abs(det) >= DET_EPS)
        invdet = 1.0 / jnp.where(jnp.abs(det) >= DET_EPS, det, 1.0)
        tvec = ob - v0
        u = jnp.sum(tvec * pvec, axis=-1) * invdet
        valid &= (u >= 0.0) & (u <= 1.0)
        qvec = jnp.cross(tvec, e1)
        v = jnp.sum(db * qvec, axis=-1) * invdet
        valid &= (v >= 0.0) & (u + v <= 1.0)
        t = jnp.sum(e2 * qvec, axis=-1) * invdet
        valid &= (t >= T_MIN) & (t > t_prev[:, None])

        t = jnp.where(valid, t, jnp.inf)
        j = jnp.argmin(t, axis=1)
        rows = jnp.arange(r)
        tj = t[rows, j]
        better = tj < bt
        bt = jnp.where(better, tj, bt)
        bi = jnp.where(better, prim_ids[rows, j], bi)
        bu = jnp.where(better, u[rows, j], bu)
        bv = jnp.where(better, v[rows, j], bv)
        bb = jnp.where(better, det[rows, j] < 0.0, bb)

        # Descend into internal hits; skip leaves (tested) and misses.
        nxt = jnp.where(hit_box & ~is_leaf, i_safe + 1, skip)
        i = jnp.where(active, nxt, i)
        return (i, bt, bi, bu, bv, bb)

    init = (
        jnp.zeros((r,), jnp.int32),
        jnp.full((r,), jnp.inf, jnp.float32),
        jnp.full((r,), -1, jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.bool_),
    )
    i, bt, bi, bu, bv, bb = jax.lax.while_loop(cond, body, init)
    kind = jnp.where(jnp.isfinite(bt), KIND_TRIANGLE, KIND_NONE).astype(jnp.int32)
    return HitRecord(t=bt, kind=kind, prim=bi, u=bu, v=bv, backface=bb,
                     packed=jnp.full_like(bi, -1))
