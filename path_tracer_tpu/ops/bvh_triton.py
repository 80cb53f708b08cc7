"""BVH closest-hit and any-hit walks as Pallas kernels for the GPU (Triton).

Route: ``pl.pallas_call(..., backend="triton")``. One program handles a block
of ``BLOCK_RAYS`` rays; each lane walks the same stackless skip-pointer DFS
node array as ``ops.bvh_traverse.closest_hit_triangles_bvh`` (hit -> i+1,
miss or leaf -> skip[i]) inside a ``lax.while_loop`` that runs until every
lane of the block has escaped. Node rows and leaf triangles are fetched with
integer-array loads straight from the tables the jnp walk reads
(``bvh_nodes`` [N,8], ``bvh_tris`` [M,9]), so the opacity-partition views
(``device_scene.opaque_view`` / ``transparent_view``) work unchanged.

Why a kernel: the jnp walk is one ``while_loop`` over the whole wavefront,
so every step writes the [R] loop state to device memory and reads it back,
gathers an [R, leaf, 9] triangle window for every lane (finished or not),
and runs until the slowest lane of the wavefront exits. Here ray state stays
in registers, divergence is bounded by one block, and the node/triangle
tables are read through L2.

Arithmetic follows the jnp walk operation by operation, so interpret mode
matches it exactly. Compiled for the GPU, the compiler contracts
multiply-adds into FMAs, which moves Möller-Trumbore terms by a few ulps;
grazing hits (u, v or t on a test boundary) can then flip, so kind/prim may
disagree on a tiny fraction of rays and t by a relative 1e-5.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from path_tracer_tpu.ops.intersect import (
    DET_EPS,
    KIND_NONE,
    KIND_TRIANGLE,
    T_MIN,
    HitRecord,
)

# Rays per program. A power of two (Triton block shapes must be); one ray
# per thread at 4 warps.
BLOCK_RAYS = 128
NUM_WARPS = 4


def _slab(o, inv, mn, mx):
    """(tn, tf) of the ray/box slab test, with the jnp walk's NaN rule: an
    axis whose (bound - o) * inv is 0 * inf contributes (-inf, +inf).
    Triton's min/max ignore NaN while XLA's propagate it, so the NaN lanes
    are masked explicitly instead of relying on either."""
    tn = None
    tf = None
    for k in range(3):
        t0 = (mn[k] - o[k]) * inv[k]
        t1 = (mx[k] - o[k]) * inv[k]
        bad = jnp.isnan(t0) | jnp.isnan(t1)
        lo = jnp.where(bad, -jnp.inf, jnp.minimum(t0, t1))
        hi = jnp.where(bad, jnp.inf, jnp.maximum(t0, t1))
        tn = lo if tn is None else jnp.maximum(tn, lo)
        tf = hi if tf is None else jnp.minimum(tf, hi)
    return tn, tf


def _moller_trumbore(o, dv, tri):
    """(t, u, v, det, ok) per lane for one triangle per lane; tri is the
    9-tuple (v0, e1, e2) of [B] columns. Same operation order as the jnp
    walk (``bvh_traverse``: sums over the last axis run x, y, z)."""
    v0, e1, e2 = tri[0:3], tri[3:6], tri[6:9]
    px = dv[1] * e2[2] - dv[2] * e2[1]
    py = dv[2] * e2[0] - dv[0] * e2[2]
    pz = dv[0] * e2[1] - dv[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    ok = jnp.abs(det) >= DET_EPS
    invdet = 1.0 / jnp.where(ok, det, 1.0)
    tx, ty, tz = o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]
    u = (tx * px + ty * py + tz * pz) * invdet
    ok &= (u >= 0.0) & (u <= 1.0)
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    v = (dv[0] * qx + dv[1] * qy + dv[2] * qz) * invdet
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * invdet
    return t, u, v, det, ok


def _walk_kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, lim_ref,
                 nodes_ref, links_ref, tris_ref, *out_refs,
                 n_nodes: int, leaf_size: int, any_hit: bool):
    """One block of rays. ``lim`` is t_prev (closest hit: hits need
    t > t_prev) or t_max (any hit: hits need t <= t_max, -1 = dead lane)."""
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    dv = (dx_ref[...], dy_ref[...], dz_ref[...])
    inv = tuple(1.0 / c for c in dv)
    lim = lim_ref[...]
    b = lim.shape[0]
    t_prev = jnp.full((b,), -1.0, jnp.float32) if any_hit else lim

    def cond(state):
        return jnp.max((state[0] < n_nodes).astype(jnp.int32)) > 0

    def body(state):
        i, bt, bi, bu, bv, bb = state
        active = i < n_nodes
        i_safe = jnp.minimum(i, n_nodes - 1)
        mn = tuple(nodes_ref[i_safe * 6 + k] for k in range(3))
        mx = tuple(nodes_ref[i_safe * 6 + 3 + k] for k in range(3))
        skip = links_ref[i_safe * 2]
        leaf = links_ref[i_safe * 2 + 1]
        first = leaf >> 8
        count = leaf & 0xFF
        tn, tf = _slab(o, inv, mn, mx)
        # Closest hit prunes boxes beyond the running best; any hit beyond
        # the range limit (bt stays +inf there, so the test reads t_max).
        bound = lim if any_hit else bt
        hit_box = (active & (tf >= jnp.maximum(tn, 0.0)) & (tn <= bound)
                   & (tf > t_prev))
        is_leaf = count > 0
        leaf_active = hit_box & is_leaf
        for j in range(leaf_size):
            live = leaf_active & (j < count)
            row = (first + j) * 9
            tri = tuple(plgpu.load(tris_ref.at[row + k], mask=live, other=0.0)
                        for k in range(9))
            t, u, v, det, ok = _moller_trumbore(o, dv, tri)
            ok &= live & (t >= T_MIN) & (t > t_prev)
            if any_hit:
                ok &= t <= lim
                bt = jnp.where(ok, t, bt)
            else:
                better = ok & (t < bt)
                bt = jnp.where(better, t, bt)
                bi = jnp.where(better, first + j, bi)
                bu = jnp.where(better, u, bu)
                bv = jnp.where(better, v, bv)
                bb = jnp.where(better, (det < 0.0).astype(jnp.int32), bb)
        nxt = jnp.where(hit_box & ~is_leaf, i_safe + 1, skip)
        if any_hit:
            # First occluder found: the lane is done.
            nxt = jnp.where(bt < jnp.inf, n_nodes, nxt)
        i = jnp.where(active, nxt, i)
        return i, bt, bi, bu, bv, bb

    # Lanes that can never hit (any hit with t_max < 0, closest hit with
    # t_prev = +inf) start finished.
    dead = (lim < 0.0) if any_hit else (lim == jnp.inf)
    init = (jnp.where(dead, n_nodes, 0).astype(jnp.int32),
            jnp.full((b,), jnp.inf, jnp.float32),
            jnp.full((b,), -1, jnp.int32),
            jnp.zeros((b,), jnp.float32),
            jnp.zeros((b,), jnp.float32),
            jnp.zeros((b,), jnp.int32))
    _, bt, bi, bu, bv, bb = jax.lax.while_loop(cond, body, init)
    if any_hit:
        out_refs[0][...] = (bt < jnp.inf).astype(jnp.int32)
    else:
        t_ref, prim_ref, u_ref, v_ref, bf_ref = out_refs
        t_ref[...] = bt
        prim_ref[...] = bi
        u_ref[...] = bu
        v_ref[...] = bv
        bf_ref[...] = bb


def _run(o, d, lim, scene, any_hit: bool, interpret: bool):
    r = o.shape[0]
    rp = -(-r // BLOCK_RAYS) * BLOCK_RAYS
    pad = rp - r
    # Padded lanes are dead (t_max -1 / t_prev +inf) with a safe direction.
    lim = jnp.pad(lim.astype(jnp.float32), (0, pad),
                  constant_values=-1.0 if any_hit else jnp.inf)
    o = jnp.pad(o, ((0, pad), (0, 0)))
    d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
    nodes = scene.bvh_nodes
    n_nodes = int(scene.bvh_n_nodes)
    box = nodes[:, 0:6].reshape(-1)
    links = jax.lax.bitcast_convert_type(nodes[:, 6:8], jnp.int32).reshape(-1)
    tris = scene.bvh_tris.reshape(-1)

    lane = pl.BlockSpec((BLOCK_RAYS,), lambda i: (i,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,))
    if any_hit:
        out_shape = jax.ShapeDtypeStruct((rp,), jnp.int32)
        out_specs = lane
    else:
        out_shape = (jax.ShapeDtypeStruct((rp,), jnp.float32),
                     jax.ShapeDtypeStruct((rp,), jnp.int32),
                     jax.ShapeDtypeStruct((rp,), jnp.float32),
                     jax.ShapeDtypeStruct((rp,), jnp.float32),
                     jax.ShapeDtypeStruct((rp,), jnp.int32))
        out_specs = (lane,) * 5
    kernel = functools.partial(_walk_kernel, n_nodes=n_nodes,
                               leaf_size=int(scene.bvh_leaf_size),
                               any_hit=any_hit)
    out = pl.pallas_call(
        kernel,
        grid=(rp // BLOCK_RAYS,),
        in_specs=[lane] * 7 + [whole(box), whole(links), whole(tris)],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bvh_anyhit" if any_hit else "bvh_closest",
    )(o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], lim,
      box, links, tris)
    return out


def closest_hit_triangles_kernel(o, d, t_prev, scene,
                                 interpret: bool = False) -> HitRecord:
    """Closest triangle hit with t > max(T_MIN, t_prev); the kernel twin of
    ``bvh_traverse.closest_hit_triangles_bvh`` (same record, global prim
    ids). o, d: [R,3]; t_prev: [R] (+inf marks a dead lane)."""
    r = o.shape[0]
    t, prim, u, v, bf = _run(o, d, t_prev, scene, any_hit=False,
                             interpret=interpret)
    t, prim, u, v, bf = t[:r], prim[:r], u[:r], v[:r], bf[:r]
    kind = jnp.where(jnp.isfinite(t), KIND_TRIANGLE,
                     KIND_NONE).astype(jnp.int32)
    return HitRecord(t=t, kind=kind, prim=prim, u=u, v=v,
                     backface=bf != 0, packed=jnp.full_like(prim, -1))


def occluded_triangles_kernel(o, d, t_max, scene,
                              interpret: bool = False) -> jnp.ndarray:
    """[R] bool: does any triangle hit with T_MIN <= t <= t_max exist?
    The lane stops at its first occluder. t_max: [R], +inf for no range
    limit, -1 for a dead lane (occludes nothing)."""
    r = o.shape[0]
    return _run(o, d, t_max, scene, any_hit=True,
                interpret=interpret)[:r] != 0
