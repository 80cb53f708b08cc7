"""Closest-hit intersection over the flat scene SoA (pure-jnp reference path).

Semantics parity:
- Möller-Trumbore with det cutoff 1e-6, no backface culling, u in [0,1],
  v >= 0, u+v <= 1, t > 1e-6; backface flag = det < 0
  (ref: src/scene/internal/triangle.rs:38-81).
- Analytic sphere quadratic: each root valid iff >= 0; the far root's normal
  is negated (inside hit) (ref: src/scene/internal/model.rs:26-63).

The reference's ``ray_cast`` returns ALL hits sorted by distance
(ref: src/renderer/utils.rs:11-21) to support stochastic alpha walking and
opacity shadows. Variable-length sorted lists do not fit fixed-shape
wavefronts; the equivalent is *closest-hit with an advancing ``t_prev``*: calling
``closest_hit`` with ``t_prev`` set to the previous hit's t yields the next
hit along the ray, reproducing the sorted walk one bounded step at a time.

All functions are fixed-shape and fully vectorized over rays. This module is
the semantic reference; the GPU BVH kernels (ops/bvh_triton.py) are checked
against it.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

DET_EPS = 1e-6
T_MIN = 1e-6
# Minimum opacity for the stochastic alpha-accept test (ref mod.rs:201).
ALPHA_MIN_OPACITY = 0.001

KIND_NONE = 0
KIND_TRIANGLE = 1
KIND_SPHERE = 2


class HitRecord(NamedTuple):
    """SoA closest-hit record for a ray wavefront. t = +inf means miss."""

    t: jnp.ndarray  # [R] f32
    kind: jnp.ndarray  # [R] int32 (0 none / 1 triangle / 2 sphere)
    prim: jnp.ndarray  # [R] int32 index into tri_* or sph_* arrays
    u: jnp.ndarray  # [R] f32 barycentric (triangles)
    v: jnp.ndarray  # [R] f32
    backface: jnp.ndarray  # [R] bool: tri det<0 | sphere far-root (inside) hit
    # Shading-row id (index into scene.sl_attr) when the reporting path
    # knows it (sphere hits, dense transparent columns); -1 otherwise.
    # Shading falls back to scene.sl_inv[prim] for -1 lanes.
    packed: jnp.ndarray  # [R] int32

    @property
    def valid(self):
        return self.kind != KIND_NONE


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def moller_trumbore(o, d, v0, e1, e2, t_prev):
    """MT intersection for [R] rays x [B] triangles → (t, u, v, back, valid),
    each [R,B]. o,d: [R,3]; v0,e1,e2: [B,3]; t_prev: [R]."""
    o = o[:, None, :]
    d = d[:, None, :]
    v0 = v0[None, :, :]
    e1 = e1[None, :, :]
    e2 = e2[None, :, :]

    pvec = jnp.cross(d, e2)
    det = _dot(e1, pvec)  # [R,B]
    valid = jnp.abs(det) >= DET_EPS
    invdet = 1.0 / jnp.where(valid, det, 1.0)

    tvec = o - v0
    u = _dot(tvec, pvec) * invdet
    valid &= (u >= 0.0) & (u <= 1.0)

    qvec = jnp.cross(tvec, e1)
    v = _dot(d, qvec) * invdet
    valid &= (v >= 0.0) & (u + v <= 1.0)

    t = _dot(e2, qvec) * invdet
    valid &= (t >= T_MIN) & (t > t_prev[:, None])
    return t, u, v, det < 0.0, valid


def closest_hit_triangles(o, d, t_prev, scene, block: int = 512) -> HitRecord:
    """Scan triangle blocks keeping a running argmin. o,d: [R,3]; t_prev: [R]."""
    n = scene.tri_v0.shape[0]
    block = min(block, n)
    while n % block:  # n is padded to a multiple of 256 (_TRI_PAD)
        block //= 2
    r = o.shape[0]

    v0b = scene.tri_v0.reshape(-1, block, 3)
    e1b = scene.tri_e1.reshape(-1, block, 3)
    e2b = scene.tri_e2.reshape(-1, block, 3)
    base = jnp.arange(n, dtype=jnp.int32).reshape(-1, block)

    init = (
        jnp.full((r,), jnp.inf, jnp.float32),
        jnp.full((r,), -1, jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.bool_),
    )

    def body(carry, blk):
        bt, bi, bu, bv, bb = carry
        v0, e1, e2, idx = blk
        t, u, v, back, valid = moller_trumbore(o, d, v0, e1, e2, t_prev)
        t = jnp.where(valid, t, jnp.inf)
        j = jnp.argmin(t, axis=1)  # [R]
        rows = jnp.arange(r)
        tj = t[rows, j]
        better = tj < bt
        carry = (
            jnp.where(better, tj, bt),
            jnp.where(better, idx[j], bi),
            jnp.where(better, u[rows, j], bu),
            jnp.where(better, v[rows, j], bv),
            jnp.where(better, back[rows, j], bb),
        )
        return carry, None

    (bt, bi, bu, bv, bb), _ = jax.lax.scan(body, init, (v0b, e1b, e2b, base))
    kind = jnp.where(jnp.isfinite(bt), KIND_TRIANGLE, KIND_NONE).astype(jnp.int32)
    return HitRecord(t=bt, kind=kind, prim=bi, u=bu, v=bv, backface=bb,
                     packed=jnp.full_like(bi, -1))


def _sphere_quadratic(o, d, scene):
    """(a [R,1], b [R,S], cc [R,S]) of the per-sphere quadratic in the
    reference's centered oc = o - c form (ref model.rs:26-37), component-wise
    so only [R,S] intermediates materialize (never [R,S,3]).

    Do NOT rewrite this as |o|^2 - 2 o.c + |c|^2 - r^2 matmuls: that
    expansion cancels catastrophically in f32 for rays originating ON a
    sphere (shadow/bounce rays biased 1e-5 off the surface), producing
    spurious self-occlusion — a ~20% energy deficit on sphere scenes that
    the oracle parity gate caught)."""
    c = scene.sph_center  # [S,3]
    radius = scene.sph_radius  # [S]
    a = _dot(d, d)[:, None]  # [R,1]
    ocx = o[:, 0:1] - c[None, :, 0]  # [R,S]
    ocy = o[:, 1:2] - c[None, :, 1]
    ocz = o[:, 2:3] - c[None, :, 2]
    b = 2.0 * (ocx * d[:, 0:1] + ocy * d[:, 1:2] + ocz * d[:, 2:3])
    cc = ocx * ocx + ocy * ocy + ocz * ocz - (radius * radius)[None, :]
    return a, b, cc


def closest_hit_spheres(o, d, t_prev, scene) -> HitRecord:
    """Nearest valid sphere root per ray. Root valid iff root >= 0 (each root
    checked individually, ref model.rs:38-41,50) and root > t_prev. The far
    root carries a negated (inside) normal — tracked via ``backface``."""
    a, b, cc = _sphere_quadratic(o, d, scene)
    disc = b * b - 4.0 * a * cc
    has = disc >= 0.0
    sq = jnp.sqrt(jnp.where(has, disc, 0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)

    tp = t_prev[:, None]
    v1 = has & (t1 >= 0.0) & (t1 > tp)
    v2 = has & (t2 >= 0.0) & (t2 > tp)
    # nearest valid root per sphere (t1 <= t2 always)
    t_near = jnp.where(v1, t1, jnp.where(v2, t2, jnp.inf))
    far_root = ~v1 & v2

    j = jnp.argmin(t_near, axis=1)
    rows = jnp.arange(o.shape[0])
    tj = t_near[rows, j]
    kind = jnp.where(jnp.isfinite(tj), KIND_SPHERE, KIND_NONE).astype(jnp.int32)
    return HitRecord(
        t=tj,
        kind=kind,
        prim=j.astype(jnp.int32),
        u=jnp.zeros_like(tj),
        v=jnp.zeros_like(tj),
        backface=far_root[rows, j],
        packed=jnp.full(tj.shape, -1, jnp.int32),
    )


def _detach_for_kernel(*args):
    """stop_gradient for Pallas kernel inputs. The kernels have no AD rules,
    and hit geometry is a detached discrete event by design (SURVEY §7) —
    without this, jax.grad fails to linearize the pallas_call. The jnp
    walks never needed it because they are differentiable and the walks
    detach their OUTPUTS; gradients flow through shading (positions,
    falloff, BRDF), never through intersection, on both paths.
    """
    return jax.lax.stop_gradient(args)


def occluded(o, d, scene, surf_pos=None, max_dist=None,
             block: int = 512, active=None) -> jnp.ndarray:
    """[R] bool any-hit occlusion query — the fast shadow path for fully
    opaque scenes, where the reference's occluder walk (ref mod.rs:283-331)
    reduces to "is there ANY occluder (within range)".

    For point lights pass surf_pos [R,3] and max_dist [R]: an occluder
    counts only when its distance FROM THE SURFACE POINT is <= max_dist
    (the reference breaks at the first occluder beyond the light,
    mod.rs:320-323; with all hits opaque, any-in-range == nearest-in-range).
    Distance uses |o + t*d - surf_pos| like the reference, expanded as
    t^2|d|^2 + 2t(b.d) + |b|^2 with b = o - surf_pos (no [R,B,3] blowup).
    """
    r = o.shape[0]
    if max_dist is not None:
        bvec = o - surf_pos
        b_dot_d = _dot(bvec, d)[:, None]
        b_sq = _dot(bvec, bvec)[:, None]
        d_sq = _dot(d, d)[:, None]
        limit_sq = (max_dist * max_dist)[:, None]

        def in_range(t):
            dist_sq = t * t * d_sq + 2.0 * t * b_dot_d + b_sq
            return dist_sq <= limit_sq
    else:
        def in_range(t):
            return True

    def _exact_t_max():
        """Range limit as a per-ray t_max for the any-hit kernel:
        the positive root of |o + t d - surf|^2 = max_dist^2."""
        if max_dist is None:
            return jnp.full((r,), jnp.inf, jnp.float32)
        disc = b_dot_d[:, 0] ** 2 - d_sq[:, 0] * (b_sq[:, 0] - limit_sq[:, 0])
        return (-b_dot_d[:, 0]
                + jnp.sqrt(jnp.maximum(disc, 0.0))) / d_sq[:, 0]

    hit = jnp.zeros((r,), jnp.bool_)

    if scene.num_real_triangles != 0:
        if getattr(scene, "use_bvh", False) and use_gpu_kernels():
            # Any-hit kernel walk with per-lane exit at the first occluder.
            # The range limit becomes an exact t_max: |o + t d - surf| =
            # max_dist solved for the positive root (same dist formula as
            # in_range); dead lanes get t_max = -1 and occlude nothing.
            from path_tracer_tpu.ops.bvh_triton import occluded_triangles_kernel

            t_max = _exact_t_max()
            if active is not None:
                t_max = jnp.where(active, t_max, -1.0)
            hit = hit | occluded_triangles_kernel(
                *_detach_for_kernel(o, d, t_max, scene))
        elif getattr(scene, "use_bvh", False):
            # Nearest-hit check suffices: dist(t) is monotone in t, so if the
            # nearest hit is out of range no hit is in range.
            t_prev = jnp.full((r,), -1.0, jnp.float32)
            tri = _closest_hit_tris_dispatch(o, d, t_prev, scene, block)
            ok = tri.valid
            if max_dist is not None:
                tr = jnp.where(jnp.isfinite(tri.t), tri.t, jnp.inf)
                ok = ok & in_range(tr[:, None])[:, 0]
            hit = hit | ok
        else:
            n = scene.tri_v0.shape[0]
            blk = min(block, n)
            while n % blk:
                blk //= 2
            v0b = scene.tri_v0.reshape(-1, blk, 3)
            e1b = scene.tri_e1.reshape(-1, blk, 3)
            e2b = scene.tri_e2.reshape(-1, blk, 3)
            t_prev = jnp.full((r,), -1.0, jnp.float32)

            def body(acc, blk_data):
                v0, e1, e2 = blk_data
                t, _, _, _, valid = moller_trumbore(o, d, v0, e1, e2, t_prev)
                return acc | jnp.any(valid & in_range(t), axis=1), None

            hit, _ = jax.lax.scan(body, hit, (v0b, e1b, e2b))

    # Spheres stay in XLA, fused with the surrounding elementwise work.
    if scene.num_real_spheres != 0:
        a, b, cc = _sphere_quadratic(o, d, scene)
        disc = b * b - 4.0 * a * cc
        has = disc >= 0.0
        sq = jnp.sqrt(jnp.where(has, disc, 0.0))
        t1 = (-b - sq) / (2.0 * a)
        t2 = (-b + sq) / (2.0 * a)
        v1 = has & (t1 >= 0.0) & in_range(t1)
        v2 = has & (t2 >= 0.0) & in_range(t2)
        hit = hit | jnp.any(v1 | v2, axis=1)

    return hit


def _miss_record(r: int) -> HitRecord:
    return HitRecord(
        t=jnp.full((r,), jnp.inf, jnp.float32),
        kind=jnp.zeros((r,), jnp.int32),
        prim=jnp.zeros((r,), jnp.int32),
        u=jnp.zeros((r,), jnp.float32),
        v=jnp.zeros((r,), jnp.float32),
        backface=jnp.zeros((r,), jnp.bool_),
        packed=jnp.full((r,), -1, jnp.int32),
    )


def use_gpu_kernels() -> bool:
    """The one backend decision: True on the GPU, where BVH scenes walk with
    the Triton kernels (ops/bvh_triton.py); False on the CPU, where they take
    the jnp reference walks. Kernels never run in interpret mode here (only
    tests ask for that). Any other backend is an error, not a fallback."""
    backend = jax.default_backend()
    if backend not in ("gpu", "cpu"):
        raise RuntimeError(f"unsupported JAX backend {backend!r}: the path "
                           f"tracer runs on 'gpu' or 'cpu'")
    return backend == "gpu"


def _closest_hit_tris_dispatch(o, d, t_prev, scene, block: int,
                               active=None) -> HitRecord:
    """Pick the triangle closest-hit implementation: the BVH walk when
    scene.use_bvh (Triton kernel on the GPU, jnp walk on the CPU), else the
    brute-force block scan.

    ``active`` (optional [R] bool): dead lanes are given t_prev = +inf so
    they can never pass a box or triangle test and exit at the root."""
    if active is not None:
        t_prev = jnp.where(active, t_prev, jnp.inf)
    if getattr(scene, "use_bvh", False):
        if use_gpu_kernels():
            from path_tracer_tpu.ops.bvh_triton import (
                closest_hit_triangles_kernel,
            )

            return closest_hit_triangles_kernel(
                *_detach_for_kernel(o, d, t_prev, scene))
        from path_tracer_tpu.ops.bvh_traverse import closest_hit_triangles_bvh

        return closest_hit_triangles_bvh(o, d, t_prev, scene)
    return closest_hit_triangles(o, d, t_prev, scene, block=block)


def closest_hit(o, d, t_prev, scene, block: int = 512,
                active=None, include_spheres: bool = True) -> HitRecord:
    """Closest hit among all primitives with t > t_prev (pass t_prev=-1.0 for
    a fresh cast: triangles still enforce t > 1e-6; spheres allow t >= 0,
    matching the reference's per-type cutoffs). Primitive classes the scene
    does not contain are skipped statically (num_real_* == 0). ``active``
    masks dead lanes out of the BVH walk's work. ``include_spheres=
    False`` restricts the cast to triangles (the opacity partition's
    transparent-subset walks: all spheres live in the opaque cast)."""
    r = o.shape[0]
    has_tris = scene.num_real_triangles != 0
    has_sphs = include_spheres and scene.num_real_spheres != 0
    if active is not None:
        # Dead lanes can never satisfy t > +inf in any primitive test.
        t_prev = jnp.where(active, t_prev, jnp.inf)
    if not has_tris:
        tri = _miss_record(r)
    else:
        tri = _closest_hit_tris_dispatch(o, d, t_prev, scene, block,
                                         active=active)
    # Spheres: XLA fuses the quadratic with the surrounding elementwise
    # shading work, which a separate kernel launch would prevent.
    sph = (closest_hit_spheres(o, d, t_prev, scene) if has_sphs
           else _miss_record(r))
    if has_sphs and getattr(scene, "sph_row_base", 0):
        # Sphere hits address their sl_attr shading row directly (one wide
        # gather covers both primitive kinds; see DeviceScene.sph_row_base).
        sph = sph._replace(
            packed=jnp.where(sph.kind == KIND_SPHERE,
                             scene.sph_row_base + jnp.maximum(sph.prim, 0),
                             sph.packed))
    if not has_tris:
        return sph
    if not has_sphs:
        return tri
    tri_wins = tri.t <= sph.t  # both inf → KIND_NONE either way
    pick = lambda a, b: jnp.where(tri_wins, a, b)
    kind = pick(tri.kind, sph.kind)
    return HitRecord(
        t=pick(tri.t, sph.t),
        kind=kind,
        prim=pick(tri.prim, sph.prim),
        u=pick(tri.u, sph.u),
        v=pick(tri.v, sph.v),
        backface=pick(tri.backface, sph.backface),
        packed=pick(tri.packed, sph.packed),
    )
