"""Wavefront unidirectional Monte Carlo path-tracing integrator.

This is the accelerator-native redesign of the reference's per-pixel recursive
integrator (ref: src/renderer/mod.rs:171-333). Instead of per-pixel recursion
with variable-length sorted hit lists, path state lives in fixed-shape SoA
arrays over a ray wavefront, advanced by bounded, unrolled kernel stages —
everything jits to one XLA program with no data-dependent shapes.

Semantics reproduced exactly (quirks included):

- Bounce loop runs bounces+1 iterations (mod.rs:180).
- A ray that hits nothing on the FIRST cast of a bounce returns
  color + throughput*background (mod.rs:184-186).
- Stochastic alpha walk (mod.rs:188-205): hits are visited in distance order;
  a hit is accepted when ``op >= 1 || (op > 0.001 && rand < op)``. If NO hit
  accepts, the FARTHEST visited hit still shades — a ray that hit >= 1
  surface never escapes to the background. Implemented as a bounded
  closest-hit re-cast loop with advancing t_prev.
- Emissive adds throughput*emissive each bounce (mod.rs:245), and AGAIN
  inside eval_direct scaled by light radiance (cook_torrance.rs:57 quirk).
- Directional lights: shadow attenuation is the product of (1-opacity) over
  ALL occluders, early-out at zero (mod.rs:283-299).
- Point lights: radiance = color/(4*pi*r^2); the occluder walk stops at the
  first occluder farther from the surface than the light; the occluder's
  opacity is sampled with the ORIGINAL hit's UV and hit-type
  (``hit.get_material_sample(shadow_model)``, mod.rs:324 quirk).
- Lights whose radiance is exactly zero are skipped (mod.rs:251) — masked
  here so NaNs from eval_direct cannot leak through a zero light.
- Indirect bounce: new origin = hit + geometric_normal*1e-5 (mod.rs:58,266),
  throughput *= eval_indirect / pdf with pdf == 1 (mod.rs:270-274).
- Throughput cutoff ||T||^2 < 1e-5 terminates (mod.rs:219).
- Russian roulette only when bounce > 3: p = max(T), T /= p unconditionally,
  kill when rand > p (mod.rs:223, utils.rs:23-31).
- Shading normal: barycentric-interpolated vertex normal (NOT normalized),
  TBN normal mapping when the material has a normal texture, then backface
  flip (hit.rs:55-82). The geometric normal used for ray bias is the
  unflipped interpolated normal (hit.rs:47-52).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from path_tracer_tpu.ops import brdf, rng, texturing
from path_tracer_tpu.ops.intersect import (
    ALPHA_MIN_OPACITY,
    KIND_TRIANGLE,
    HitRecord,
    closest_hit,
)

NORMAL_BIAS = 1e-5  # ref: src/renderer/mod.rs:58
THROUGHPUT_CUTOFF = 1e-5  # ref: mod.rs:219
PI = 3.14159265358979323846


@dataclasses.dataclass(frozen=True)
class IntegratorSpec:
    """Static integrator parameters (hashable; part of the jit key)."""

    bounces: int = 4
    # None = auto: size each walk bound to the scene's num_transparent_hits
    # + 1, which makes the bounded re-cast walk EXACTLY the reference's
    # unbounded sorted-hit iteration (the while_loop early-exits, so a large
    # bound is free at runtime). An explicit int truncates the walk.
    alpha_walk_steps: int | None = None
    shadow_walk_steps: int | None = None
    seed: int = 0
    tri_block: int = 512
    # True preserves exact parameter gradients (live factor-table reads, AD-
    # safe hit reparameterization). Forward-only rendering sets False: shading
    # then reads the baked material columns of the ONE wide sl_attr row
    # gather and skips the reparameterization algebra — identical radiance
    # (same values, same formulas), measurably cheaper per bounce.
    differentiable: bool = True
    # Live-ray compaction between bounces (SURVEY §2c experiment): partition
    # every wavefront array alive-first before each bounce so dead lanes
    # cluster into all-dead tiles. On the earlier accelerator the
    # partition's argsort + gathers cost more than dead-lane masking saved,
    # so this defaults OFF; not measured on the GPU.
    compact: bool = False


class Surface(NamedTuple):
    """Shading data at the selected hit of one bounce."""

    pos: jnp.ndarray  # [R,3]
    geom_normal: jnp.ndarray  # [R,3] (unflipped interp normal / sphere normal)
    normal: jnp.ndarray  # [R,3] shading normal (normal map + backface flip)
    uv: jnp.ndarray  # [R,2]
    model: jnp.ndarray  # [R] int32
    simple: jnp.ndarray  # [R] bool — sphere hits sample factors only


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _tri_attr(scene, hit: HitRecord):
    """[R,ATTR_W] packed shading-attribute rows for hits, or None.

    One wide gather of scene.sl_attr replaces the ~12 narrow per-primitive
    gathers shading otherwise issues (see DeviceScene.sl_attr). Sphere hits
    carry packed = sph_row_base + index (their material-only rows); triangle
    hits report global prim ids, mapped global->slot via sl_inv.
    Miss lanes read slot 0 — their values are masked out by callers.
    """
    if not (getattr(scene, "use_bvh", False) and scene.num_real_triangles):
        return None
    prim = jnp.minimum(jnp.maximum(hit.prim, 0), scene.sl_inv.shape[0] - 1)
    packed = jnp.where(hit.packed >= 0, hit.packed, scene.sl_inv[prim])
    return scene.sl_attr[jnp.maximum(packed, 0)]


def _hit_model_uv(scene, hit: HitRecord, row=None):
    """(model_id [R], uv [R,2], simple [R]) for any hit record. Scenes with a
    single primitive class skip the other class's gathers statically.
    ``row``: optional precomputed _tri_attr rows (else computed here)."""
    prim = jnp.maximum(hit.prim, 0)
    if scene.num_real_triangles == 0:
        sph_i = jnp.minimum(prim, scene.sph_model.shape[0] - 1)
        r = prim.shape[0]
        return (scene.sph_model[sph_i], jnp.zeros((r, 2), jnp.float32),
                jnp.ones((r,), jnp.bool_))
    if row is None:
        row = _tri_attr(scene, hit)
    is_tri = hit.kind == KIND_TRIANGLE
    w = hit.u[:, None]
    ww = hit.v[:, None]
    if row is not None:
        uv0 = row[:, 21:23]
        uv = uv0 + w * (row[:, 23:25] - uv0) + ww * (row[:, 25:27] - uv0)
        tri_model = row[:, 27].astype(jnp.int32)
    else:
        uv0 = scene.tri_uv0[prim]
        uv = (uv0 + w * (scene.tri_uv1[prim] - uv0)
              + ww * (scene.tri_uv2[prim] - uv0))
        tri_model = scene.tri_model[prim]
    if scene.num_real_spheres == 0:
        return tri_model, uv, jnp.zeros_like(is_tri)
    if row is not None:
        # Sphere rows bake their model id in the same column — the wide
        # gather already covered every lane, no sph_model gather needed.
        model = tri_model
    else:
        model = jnp.where(is_tri, tri_model,
                          scene.sph_model[jnp.minimum(prim, scene.sph_model.shape[0] - 1)])
    uv = jnp.where(is_tri[:, None], uv, 0.0)
    return model, uv, ~is_tri


def _surface(scene, hit: HitRecord, o, d, row=None,
             differentiable: bool = True) -> Surface:
    """Gather shading geometry at the selected hits (ref hit.rs:100-137,55-82)."""
    is_tri = hit.kind == KIND_TRIANGLE
    prim = jnp.maximum(hit.prim, 0)
    sph_i = jnp.minimum(prim, scene.sph_center.shape[0] - 1)

    # Miss lanes carry t = +inf; their Surface is masked out downstream, but
    # inf would still poison reverse-mode AD through jnp.where (0 * inf).
    t_safe = jnp.where(jnp.isfinite(hit.t), hit.t, 0.0)

    sg = jax.lax.stop_gradient
    if row is None:
        row = _tri_attr(scene, hit)
    if not differentiable:
        # Forward rendering: pos = o + t d directly. The planar
        # reparameterization below is VALUE-identical (p0 lies on the hit
        # plane) — it exists purely so AD slides the hit point along the
        # surface instead of off it.
        pos = o + d * t_safe[:, None]
    else:
        # Reparameterization of the hit distance: t is a discrete
        # intersector output (detached), so pos = o + t*d alone gives
        # gradients that move the hit point OFF the surface when o/d depend
        # on parameters (camera transform).
        #
        # Triangles: recompute t as the ray/plane intersection with a
        # DETACHED anchor point and surface plane — t = ((p0-o).n0)/(d.n0) —
        # value-identical (p0 = o + t d lies on the plane) but its derivative
        # slides the hit point ALONG the surface, making camera gradients
        # first-order exact away from silhouettes. Grazing lanes
        # (|d.n0| ~ 0) fall back to the detached t.
        #
        # Spheres: re-derive t from the DIFFERENTIABLE quadratic root using
        # the live center/radius arrays (root CHOICE — near vs far — is the
        # detached discrete event, keyed by hit.backface). Applied as a
        # straight-through estimator (value = detached t, tangent = d t_quad)
        # so forward values are bit-identical to the detached path while
        # camera AND sphere-parameter (center/radius) gradients are
        # first-order exact away from silhouettes.
        p0 = sg(o + d * t_safe[:, None])
        if scene.num_real_triangles != 0:
            if row is not None:
                face_n = jnp.cross(row[:, 3:6], row[:, 6:9])
            else:
                face_n = jnp.cross(scene.tri_e1[prim], scene.tri_e2[prim])
            plane_n = sg(face_n)
            dn = _dot(d, plane_n)
            ok_plane = jnp.abs(dn) > 1e-12 * sg(
                jnp.abs(_dot(p0 - o, plane_n)) + 1.0)
            t_plane = _dot(p0 - o, plane_n) / jnp.where(ok_plane, dn, 1.0)
            t_tri = jnp.where(ok_plane & jnp.isfinite(hit.t), t_plane, t_safe)
        else:
            t_tri = None
        if scene.num_real_spheres != 0:
            center = scene.sph_center[sph_i]
            radius = scene.sph_radius[sph_i]
            oc = o - center
            aq = _dot(d, d)
            bq = _dot(oc, d)  # half-b form of the quadratic
            cq = _dot(oc, oc) - radius * radius
            disc = bq * bq - aq * cq
            ok_sph = disc > 0.0
            sq = jnp.sqrt(jnp.where(ok_sph, disc, 1.0))
            root = (-bq + jnp.where(hit.backface, sq, -sq)) / aq
            t_quad = jnp.where(ok_sph & jnp.isfinite(hit.t), root, t_safe)
            t_sph = t_safe + (t_quad - sg(t_quad))  # straight-through
        else:
            t_sph = None
        if t_tri is None:
            t_rep = t_sph
        elif t_sph is None:
            t_rep = t_tri
        else:
            t_rep = jnp.where(is_tri, t_tri, t_sph)
        pos = o + d * t_rep[:, None]
    model, uv, simple = _hit_model_uv(scene, hit, row=row)

    # Triangle: barycentric vertex-normal interpolation (NOT normalized).
    if scene.num_real_triangles != 0:
        w1 = hit.u[:, None]
        w2 = hit.v[:, None]
        if row is not None:
            n_interp = ((1.0 - w1 - w2) * row[:, 9:12]
                        + w1 * row[:, 12:15] + w2 * row[:, 15:18])
        else:
            n_interp = (
                (1.0 - w1 - w2) * scene.tri_n0[prim]
                + w1 * scene.tri_n1[prim]
                + w2 * scene.tri_n2[prim]
            )
    else:
        n_interp = None

    # Sphere geometric normal: outward, negated for far-root (inside) hits
    # (ref model.rs:44,57 — the far hit's normal is pre-negated in the Hit).
    if scene.num_real_spheres != 0:
        center = scene.sph_center[sph_i]
        sph_n = pos - center
        # rsqrt of clamped n^2: jnp.linalg.norm has a NaN vjp at zero.
        sph_n = sph_n * jax.lax.rsqrt(jnp.maximum(
            jnp.sum(sph_n * sph_n, axis=-1, keepdims=True), 1e-24))
        sph_n = jnp.where(hit.backface[:, None], -sph_n, sph_n)
    else:
        sph_n = None

    if n_interp is None:
        geom_n = sph_n
    elif sph_n is None:
        geom_n = n_interp
    else:
        geom_n = jnp.where(is_tri[:, None], n_interp, sph_n)

    if n_interp is None:
        # Sphere-only scene: shading normal == geometric sphere normal.
        normal = sph_n
    else:
        # Normal mapping (triangles with a normal texture): TBN*map, normed.
        nm, has_map = texturing.sample_normal_map(scene, model, uv, rows=row)
        if nm is None:  # statically texture-free scene — skip the TBN branch
            tri_shading_n = n_interp
        else:
            tangent = row[:, 18:21] if row is not None else scene.tri_tangent[prim]
            bitangent = jnp.cross(n_interp, tangent)
            mapped = (tangent * nm[:, 0:1] + bitangent * nm[:, 1:2]
                      + n_interp * nm[:, 2:3])
            mapped = mapped * jax.lax.rsqrt(jnp.maximum(
                jnp.sum(mapped * mapped, axis=-1, keepdims=True), 1e-24))
            tri_shading_n = jnp.where((has_map & is_tri)[:, None], mapped,
                                      n_interp)
        # Backface flip applies to triangles only (sphere pre-negates).
        tri_shading_n = jnp.where((hit.backface & is_tri)[:, None],
                                  -tri_shading_n, tri_shading_n)
        normal = (tri_shading_n if sph_n is None
                  else jnp.where(is_tri[:, None], tri_shading_n, sph_n))

    return Surface(pos=pos, geom_normal=geom_n, normal=normal, uv=uv,
                   model=model, simple=simple)


def _alpha_walk(scene, o, d, walking, pixel_ids, sample_id, bounce, spec,
                steps: int):
    """Stochastic alpha-transparency hit walk (ref mod.rs:188-205).

    Returns (sel: HitRecord of the shading hit, seen_any [R], first_missed [R]).
    first_missed = the FIRST cast found nothing → background path.
    For all-opaque scenes ``steps == 1``: the first hit always accepts.
    """
    r = o.shape[0]
    sel0 = HitRecord(
        t=jnp.full((r,), jnp.inf, jnp.float32),
        kind=jnp.zeros((r,), jnp.int32),
        prim=jnp.zeros((r,), jnp.int32),
        u=jnp.zeros((r,), jnp.float32),
        v=jnp.zeros((r,), jnp.float32),
        backface=jnp.zeros((r,), jnp.bool_),
        packed=jnp.full((r,), -1, jnp.int32),
    )

    # Fully opaque scene: every visited hit accepts (op >= 1 short-circuits
    # the stochastic test, mod.rs:201), so the walk is exactly ONE cast with
    # no opacity sampling, rng draw, or while_loop around it.
    if steps == 1 and scene.all_opaque:
        t_prev = jnp.full((r,), -1.0, jnp.float32)
        hit = closest_hit(o, d, t_prev, scene, block=spec.tri_block,
                          active=walking if scene.use_bvh else None)
        found = walking & hit.valid
        sel = HitRecord(*[jnp.where(found, h, s) for h, s in zip(hit, sel0)])
        sel = jax.lax.stop_gradient(sel)
        return sel, found, walking & ~found

    from path_tracer_tpu.scene.device_scene import partitioned

    if partitioned(scene):
        return _alpha_walk_partitioned(scene, o, d, walking, pixel_ids,
                                       sample_id, bounce, spec, steps, sel0)

    def cond(carry):
        k, sel, seen_any, t_prev, active = carry
        return (k < steps) & jnp.any(active)

    def step(carry):
        k, sel, seen_any, t_prev, active = carry
        hit = closest_hit(o, d, t_prev, scene, block=spec.tri_block,
                          active=active if scene.use_bvh else None)
        found = active & hit.valid
        # Opacity of this candidate hit at its own UV/type.
        walk_row = _tri_attr(scene, hit)
        model, uv, simple = _hit_model_uv(scene, hit, row=walk_row)
        op = texturing.sample_opacity(
            scene, model, uv, simple,
            rows=None if spec.differentiable else walk_row)
        # Stride from the walk-aware layout: site 2+k can never collide
        # with this bounce's GGX/RR sites, however deep the walk.
        stride = rng.site_layout(steps)[3]
        rnd = rng.uniform(pixel_ids, sample_id,
                          rng.SITE_ALPHA + k + stride * bounce, spec.seed)
        accept = (op >= 1.0) | ((op > ALPHA_MIN_OPACITY) & (rnd < op))
        # The walk records EVERY visited hit; the last one shades if none accept.
        sel = HitRecord(*[jnp.where(found, h, s) for h, s in zip(hit, sel)])
        seen_any = seen_any | found
        # Continue only for rays that found a hit and rejected it.
        active = found & ~accept
        t_prev = jnp.where(active, hit.t, t_prev)
        return (k + 1, sel, seen_any, t_prev, active)

    # Early-exit while_loop: mostly-opaque wavefronts stop after 1-2 casts
    # instead of always paying `steps` full traversals. The outputs are
    # DETACHED (stop_gradient): hit selection is a discrete event (SURVEY §7)
    # and lax.while_loop has no reverse-mode rule — gradients w.r.t.
    # materials/lights flow through shading, never through hit geometry.
    init = (jnp.int32(0), sel0, jnp.zeros((r,), jnp.bool_),
            jnp.full((r,), -1.0, jnp.float32), walking)
    _, sel, seen_any, _, _ = jax.lax.stop_gradient(
        jax.lax.while_loop(cond, step, init)
    )

    first_missed = walking & ~seen_any
    return sel, seen_any, first_missed


def _hits_transparent_bounds(scene, o, d, t_max):
    """[R] bool: can the segment o + t d, t in (0, t_max], touch ANY
    transparent-cluster AABB (scene.tr_prefilter, 32 boxes)? Pure fused
    elementwise XLA — no gather, no kernel launch — so it is cheap next to
    the per-chunk cast launches it lets the partitioned walks skip.
    Conservative:
    padding boxes are degenerate far points that never pass."""
    boxes = scene.tr_prefilter  # [P,6]
    inv = 1.0 / d  # [R,3]; IEEE inf on zero components
    # Component-major: [R,P] intermediates only (P=32).
    t0 = (boxes[None, :, 0:3] - o[:, None, :]) * inv[:, None, :]
    t1 = (boxes[None, :, 3:6] - o[:, None, :]) * inv[:, None, :]
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    tn = jnp.max(jnp.where(jnp.isnan(lo), -jnp.inf, lo), axis=-1)  # [R,P]
    tf = jnp.min(jnp.where(jnp.isnan(hi), jnp.inf, hi), axis=-1)
    ok = (tf >= jnp.maximum(tn, 0.0)) & (tn <= t_max[:, None])
    return jnp.any(ok, axis=-1)


def _walk_chunks(r: int) -> int:
    """Sub-wavefront chunk count for the partitioned transparent walks.

    A while_loop walk pays its body (casts + row/texel gathers over ALL
    lanes) for the GLOBAL max iteration count; mapping the walk over C
    chunks pays each chunk only its own max — under Morton pixel order the
    transparent geometry clusters, so most chunks drain in 0-1 iterations
    (on the textured showcase rays cross at most 4 transparent surfaces).
    Default: 2048-lane chunks.
    PT_WALK_CHUNKS overrides the chunk COUNT (1 disables)."""
    import os

    env = os.environ.get("PT_WALK_CHUNKS")
    c = int(env) if env else max(1, r // 2048)
    if c <= 1 or r % c != 0 or (r // c) % 256 != 0:
        return 1
    return c


def _use_dense_tr(scene) -> bool:
    """Static gate for the DENSE (column) transparent-walk path.

    When the transparent partition is small (foliage cards, decals — the
    reference's alpha content is exactly this shape), the bounded walks can
    precompute EVERY candidate hit + its opacity up front (one fused MT
    matrix pass) and collapse to a statically-unrolled column loop of pure
    vector math — value-identical to the per-iteration cast walk (same
    strict t > t_prev advance, same MT math — ops/intersect.py; gated by
    test_partition.test_dense_tr_walk_matches_cast_walk).

    On by default up to PT_DENSE_TR_MAX (4096) transparent triangles, on
    the CPU and the GPU alike: on the GPU the cast walk's chunked
    while_loops are launch-bound (PERF.md, H100 bring-up), the dense walk
    is a few large fusions. PT_NO_DENSE_TR=1 forces the cast walk (A/B +
    parity testing)."""
    import os

    if os.environ.get("PT_NO_DENSE_TR") == "1":
        return False
    t = scene.tri_v0.shape[0] - scene.n_tris_opaque
    return 0 < t <= int(os.environ.get("PT_DENSE_TR_MAX", "4096"))


def _dense_tr_hits(scene, o, d, steps):
    """(ts, pos) [min(steps,T), R]: each ray's `steps` nearest transparent
    hits, produced up front for a FULL wavefront in one pass: a
    component-major jnp MT matrix pass (only [R,T] 2D intermediates, never
    [R,T,3]; same trick as _sphere_quadratic) + `steps` argmin passes.
    Contract: ascending t with the cast walk's strict t > t_prev
    duplicate-skip baked in, +inf past the end, ties to the lowest triangle
    index (jnp.argmin order). Inactive lanes are masked by the walks."""
    from path_tracer_tpu.ops.intersect import DET_EPS, T_MIN

    c = scene.n_tris_opaque
    tri_v0, tri_e1, tri_e2 = scene.tri_v0, scene.tri_e1, scene.tri_e2
    # The auto walk bound (`steps` = num_transparent_hits + 1) can be the
    # WHOLE transparent set — free for the early-exiting cast walk, ruinous
    # for a precompute. Cap the precomputed hits at PT_DENSE_TR_K (max
    # productive crossings on the textured showcase: 4); iterations past
    # the cap fall back to exact per-iteration casts in the residual walk,
    # so semantics never truncate.
    kk = _dense_k(scene, steps)
    ox, oy, oz = (o[:, k : k + 1] for k in range(3))  # [R,1]
    dx, dy, dz = (d[:, k : k + 1] for k in range(3))
    v0x, v0y, v0z = (tri_v0[c:, k][None, :] for k in range(3))  # [1,T]
    ax, ay, az = (tri_e1[c:, k][None, :] for k in range(3))  # e1
    bx, by, bz = (tri_e2[c:, k][None, :] for k in range(3))  # e2
    px = dy * bz - dz * by  # pvec = d x e2, [R,T]
    py = dz * bx - dx * bz
    pz = dx * by - dy * bx
    det = ax * px + ay * py + az * pz
    valid = jnp.abs(det) >= DET_EPS
    inv = 1.0 / jnp.where(valid, det, 1.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z  # tvec
    u = (tx * px + ty * py + tz * pz) * inv
    valid &= (u >= 0.0) & (u <= 1.0)
    qx = ty * az - tz * ay  # qvec = tvec x e1
    qy = tz * ax - tx * az
    qz = tx * ay - ty * ax
    v = (dx * qx + dy * qy + dz * qz) * inv
    valid &= (v >= 0.0) & (u + v <= 1.0)
    t = (bx * qx + by * qy + bz * qz) * inv
    valid &= t >= T_MIN
    tm = jnp.where(valid, t, jnp.inf)  # [R,T]

    # `steps` argmin passes (cheaper than a lax.top_k sort for K<=~6).
    # Each pass knocks out every entry with
    # t <= the selected t = the cast walk's strict t > t_prev advance:
    # EXACT duplicate ts (shared foliage-card edges report both
    # triangles at one t) are skipped; ties pick the lowest triangle
    # index like the argmin a cast runs.
    ts_cols, pos_cols = [], []
    work = tm
    for _ in range(kk):
        j = jnp.argmin(work, axis=1)
        tj = jnp.min(work, axis=1)
        ts_cols.append(tj)
        pos_cols.append(j.astype(jnp.int32))
        work = jnp.where(work <= tj[:, None], jnp.inf, work)
    ts = jnp.stack(ts_cols, axis=0)  # [kk,R] ascending, +inf past end
    pos = jnp.stack(pos_cols, axis=0)
    return ts, pos


def _dense_k(scene, steps: int) -> int:
    """Static column count of the dense precompute (see _dense_tr_hits)."""
    import os

    return min(steps, scene.tri_v0.shape[0] - scene.n_tris_opaque,
               int(os.environ.get("PT_DENSE_TR_K", "6")))


def _dense_hit_columns(scene, o, d, ts, pos):
    """FLAT HitRecord ([kk*R] fields) for every precomputed candidate hit.

    Reconstructs u/v/backface for all kk*R (ray, hit) pairs in ONE batched
    pass: the triangle data comes from a single gather of the [9, T] packed
    table (column-major — the output [9, kk*R] keeps the long axis
    contiguous). Same MT formulas as ops/intersect.py; `packed` via
    sl_inv like the jnp fallback paths. Exhausted entries (t=+inf) carry
    kind NONE.
    """
    from path_tracer_tpu.ops.intersect import DET_EPS, KIND_NONE

    kk, r = ts.shape
    c = scene.n_tris_opaque
    prim = (c + pos).reshape(kk * r)
    tf = ts.reshape(kk * r)
    fin = jnp.isfinite(tf)
    tp = scene.tri_packed_t
    tri9 = tp[:, jnp.minimum(prim, tp.shape[1] - 1)]  # [9, kk*R]

    def rep(x):  # [R] -> [kk*R]
        return jnp.broadcast_to(x[None, :], (kk, r)).reshape(kk * r)

    ox, oy, oz = rep(o[:, 0]), rep(o[:, 1]), rep(o[:, 2])
    dx, dy, dz = rep(d[:, 0]), rep(d[:, 1]), rep(d[:, 2])
    v0x, v0y, v0z = tri9[0], tri9[1], tri9[2]
    e1x, e1y, e1z = tri9[3], tri9[4], tri9[5]
    e2x, e2y, e2z = tri9[6], tri9[7], tri9[8]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv = 1.0 / jnp.where(jnp.abs(det) >= DET_EPS, det, 1.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    packed = scene.sl_inv[jnp.minimum(prim, scene.sl_inv.shape[0] - 1)]
    return HitRecord(
        t=jnp.where(fin, tf, jnp.inf),
        kind=jnp.where(fin, KIND_TRIANGLE, KIND_NONE).astype(jnp.int32),
        prim=prim,
        u=u,
        v=v,
        backface=det < 0.0,
        packed=jnp.where(fin, packed, -1),
    )


def _cols(x, kk, r):
    """[kk*R] flat field -> [kk, R] column view."""
    return x.reshape(kk, r)


def _alpha_walk_partitioned(scene, o, d, walking, pixel_ids, sample_id,
                            bounce, spec, steps, sel0):
    """Opacity-partitioned stochastic alpha walk (device_scene.partitioned):

    1. ONE closest-hit cast against the OPAQUE subset (+ all spheres, which
       are required opaque) — the walk's terminator: an opaque hit always
       accepts (op >= 1 short-circuit, ref mod.rs:201).
    2. A bounded re-cast walk over ONLY the transparent subset, restricted
       to hits strictly in front of the terminator.

    Visit order and per-visit RNG sites are IDENTICAL to the unpartitioned
    sorted walk: every transparent hit in front of the terminator is visited
    at the same index k (the opaque hit, when reached, accepts without
    consuming its site in both forms). If no hit accepts, the farthest
    visited hit still shades — which is the opaque hit when one exists,
    else the farthest transparent hit (ref mod.rs:188-205 fallback).
    """
    from path_tracer_tpu.scene.device_scene import opaque_view, transparent_view

    r = o.shape[0]
    ov = opaque_view(scene)
    tv = transparent_view(scene)
    t_neg = jnp.full((r,), -1.0, jnp.float32)
    hit_op = jax.lax.stop_gradient(
        closest_hit(o, d, t_neg, ov, block=spec.tri_block,
                    active=walking if scene.use_bvh else None))
    t_op = jnp.where(hit_op.valid, hit_op.t, jnp.inf)
    # Lanes whose segment (up to the opaque terminator) cannot touch any
    # transparent cluster skip the walk entirely (whole chunks go idle).
    # NOTE: only the WALK activity is filtered — the original ``walking``
    # still drives the miss/background bookkeeping below.
    walk_active = walking & _hits_transparent_bounds(scene, o, d, t_op)

    def cast_step(o, d, pixel_ids, t_op):
        """(cond, step) of the per-iteration CAST walk — the non-dense
        chunked walk, and the dense residual past the precompute cap."""

        def cond(carry):
            k, sel, seen, accepted, t_prev, active = carry
            return (k < steps) & jnp.any(active)

        def step(carry):
            k, sel, seen, accepted, t_prev, active = carry
            hit = closest_hit(o, d, t_prev, tv, block=spec.tri_block,
                              active=active if scene.use_bvh else None,
                              include_spheres=False)
            found = active & hit.valid & (hit.t < t_op)
            walk_row = _tri_attr(scene, hit)
            model, uv, simple = _hit_model_uv(scene, hit, row=walk_row)
            op = texturing.sample_opacity(
                scene, model, uv, simple,
                rows=None if spec.differentiable else walk_row)
            stride = rng.site_layout(steps)[3]
            rnd = rng.uniform(pixel_ids, sample_id,
                              rng.SITE_ALPHA + k + stride * bounce,
                              spec.seed)
            accept = (op >= 1.0) | ((op > ALPHA_MIN_OPACITY) & (rnd < op))
            sel = HitRecord(*[jnp.where(found, h, s)
                              for h, s in zip(hit, sel)])
            seen = seen | found
            accepted = accepted | (found & accept)
            active = found & ~accept
            t_prev = jnp.where(active, hit.t, t_prev)
            return (k + 1, sel, seen, accepted, t_prev, active)

        return cond, step

    dense = _use_dense_tr(scene)
    if dense:
        # DENSE COLUMN WALK: one producer pass yields every candidate hit's
        # full record AND opacity up front (one producer pass + batched
        # gathers); the walk itself is a statically-unrolled column loop of
        # pure vector math — no casts, no gathers, no chunking. Lanes that
        # reject all kk precomputed hits continue in the exact cast
        # residual (rare: kk covers the measured max crossings).
        kk = _dense_k(scene, steps)

        def produce(o, d):
            ts, pos = _dense_tr_hits(scene, o, d, steps)
            hit = _dense_hit_columns(scene, o, d, ts, pos)
            walk_row = _tri_attr(scene, hit)
            model, uv, simple = _hit_model_uv(scene, hit, row=walk_row)
            op = texturing.sample_opacity(
                scene, model, uv, simple,
                rows=None if spec.differentiable else walk_row)
            return tuple(hit) + (op,)

        # All-inactive wavefronts (sky tiles) skip the producer + its
        # gathers entirely — matching the cast path's zero cost there.
        flat = jax.lax.stop_gradient(jax.lax.cond(
            jnp.any(walk_active),
            produce,
            lambda o, d: (jnp.full((kk * r,), jnp.inf, jnp.float32),
                          jnp.zeros((kk * r,), jnp.int32),
                          jnp.zeros((kk * r,), jnp.int32),
                          jnp.zeros((kk * r,), jnp.float32),
                          jnp.zeros((kk * r,), jnp.float32),
                          jnp.zeros((kk * r,), jnp.bool_),
                          jnp.full((kk * r,), -1, jnp.int32),
                          jnp.zeros((kk * r,), jnp.float32)),
            o, d))
        hcols = HitRecord(*[_cols(x, kk, r) for x in flat[:7]])
        op_cols = _cols(flat[7], kk, r)

        sel = sel0
        seen_tr = jnp.zeros((r,), jnp.bool_)
        accepted = jnp.zeros((r,), jnp.bool_)
        t_prev = jnp.full((r,), -1.0, jnp.float32)
        active = walk_active
        stride = rng.site_layout(steps)[3]
        for k in range(kk):
            hit = HitRecord(*[f[k] for f in hcols])
            found = active & hit.valid & (hit.t < t_op)
            rnd = rng.uniform(pixel_ids, sample_id,
                              rng.SITE_ALPHA + k + stride * bounce,
                              spec.seed)
            op = op_cols[k]
            accept = (op >= 1.0) | ((op > ALPHA_MIN_OPACITY) & (rnd < op))
            sel = HitRecord(*[jnp.where(found, h, s)
                              for h, s in zip(hit, sel)])
            seen_tr = seen_tr | found
            accepted = accepted | (found & accept)
            active = found & ~accept
            t_prev = jnp.where(active, hit.t, t_prev)
        if kk < steps:
            condf, stepf = cast_step(o, d, pixel_ids, t_op)
            _, sel, seen_tr, accepted, _, _ = jax.lax.while_loop(
                condf, stepf,
                (jnp.int32(kk), sel, seen_tr, accepted, t_prev, active))
        sel = jax.lax.stop_gradient(sel)
        seen_tr = jax.lax.stop_gradient(seen_tr)
        accepted = jax.lax.stop_gradient(accepted)
    else:
        def run_walk(o, d, pixel_ids, walking, t_op):
            rc = o.shape[0]
            sel_init = HitRecord(*[x[:rc] for x in sel0])
            condf, stepf = cast_step(o, d, pixel_ids, t_op)
            init = (jnp.int32(0), sel_init, jnp.zeros((rc,), jnp.bool_),
                    jnp.zeros((rc,), jnp.bool_),
                    jnp.full((rc,), -1.0, jnp.float32), walking)
            _, sel, seen, accepted, _, _ = jax.lax.while_loop(condf, stepf,
                                                              init)
            return sel, seen, accepted

        n_chunks = _walk_chunks(r)
        if n_chunks == 1:
            sel, seen_tr, accepted = jax.lax.stop_gradient(
                run_walk(o, d, pixel_ids, walk_active, t_op))
        else:
            ch = lambda x: x.reshape(n_chunks, r // n_chunks, *x.shape[1:])
            sel, seen_tr, accepted = jax.lax.stop_gradient(jax.lax.map(
                lambda a: run_walk(*a),
                (ch(o), ch(d), ch(pixel_ids), ch(walk_active), ch(t_op))))
            sel = HitRecord(*[x.reshape(r, *x.shape[2:]) for x in sel])
            seen_tr = seen_tr.reshape(r)
            accepted = accepted.reshape(r)

    op_found = walking & hit_op.valid
    use_op = op_found & ~accepted
    sel = HitRecord(*[jnp.where(use_op, h, s) for h, s in zip(hit_op, sel)])
    seen_any = seen_tr | op_found
    first_missed = walking & ~seen_any
    return jax.lax.stop_gradient(sel), seen_any, first_missed


def _shadow_attenuation(scene, s_o, s_d, active, light_color, spec, steps,
                        point_dist=None, surf_pos=None, orig_model_uv=None,
                        blocked=None):
    """Occluder opacity-attenuation walk shared by both light types.

    Directional (ref mod.rs:283-299): every occluder's own material/UV.
    Point (ref mod.rs:301-331): pass point_dist [R], surf_pos [R,3] and
    orig_model_uv=(uv [R,2], simple [R]) — the walk breaks at the first
    occluder beyond the light and samples opacity at the ORIGINAL hit's
    UV/type with the occluder's material (mod.rs:324 quirk).

    Fully opaque scenes take the any-hit occlusion fast path: every occluder
    multiplies by (1-1)=0, so attenuation is binary.
    """
    att0 = jnp.where(active[:, None], jnp.broadcast_to(light_color, s_o.shape), 0.0)

    if scene.all_opaque:
        if blocked is None:
            from path_tracer_tpu.ops.intersect import occluded

            blocked = occluded(s_o, s_d, scene, surf_pos=surf_pos,
                               max_dist=point_dist, block=spec.tri_block,
                               active=active if scene.use_bvh else None)
        return jnp.where(blocked[:, None], 0.0, att0)

    # OPACITY PARTITION (device_scene.partitioned): the reference's occluder
    # walk multiplies (1-op) over occluders in distance order and breaks at
    # att == 0 (mod.rs:283-331). Any opaque occluder (within range) zeroes
    # the product regardless of order, so the walk splits into a BINARY
    # any-hit against the opaque subset + spheres (batched across lights by
    # the caller) and a transmittance walk over only the transparent subset
    # — value-identical, and the expensive full-scene re-casts disappear.
    from path_tracer_tpu.scene.device_scene import (
        partitioned,
        opaque_view,
        transparent_view,
    )

    part = partitioned(scene)
    if part:
        if blocked is None:
            from path_tracer_tpu.ops.intersect import occluded

            blocked = occluded(s_o, s_d, opaque_view(scene),
                               surf_pos=surf_pos, max_dist=point_dist,
                               block=spec.tri_block,
                               active=active if scene.use_bvh else None)
        cast_scene = transparent_view(scene)
        include_spheres = False
        active = active & ~blocked
        t_pre = (jnp.full(s_o.shape[:1], jnp.inf, jnp.float32)
                 if point_dist is None else point_dist * 1.0001 + 1e-3)
        active = active & _hits_transparent_bounds(scene, s_o, s_d, t_pre)
    else:
        cast_scene = scene
        include_spheres = True

    # The walk carries a scalar transmittance (opacity is channel-uniform);
    # the light color multiplies OUTSIDE the loop so its gradient flows
    # around the (reverse-mode-undifferentiable, detached) while_loop.
    # Early-out parity with the reference's `att == 0` break (mod.rs:297):
    # att0 != 0 lanes with transmittance 0 stop walking.
    color_nonzero = jnp.sum(jnp.abs(att0), axis=-1) != 0.0
    r = s_o.shape[0]

    walking0 = active & color_nonzero

    def cast_step(s_o, s_d, point_dist, surf_pos, orig_uv, orig_simple):
        """(cond, step) of the per-iteration CAST transmittance walk."""

        def cond(carry):
            k, trans, t_prev, walking = carry
            return (k < steps) & jnp.any(walking)

        def step(carry):
            k, trans, t_prev, walking = carry
            hit = closest_hit(s_o, s_d, t_prev, cast_scene,
                              block=spec.tri_block,
                              active=walking if scene.use_bvh else None,
                              include_spheres=include_spheres)
            found = walking & hit.valid
            walk_row = _tri_attr(scene, hit)
            model, uv, simple = _hit_model_uv(scene, hit, row=walk_row)
            if point_dist is not None:
                # Behind-the-light cutoff measured from the ORIGINAL
                # surface.
                occ_pos = s_o + s_d * jnp.where(
                    jnp.isfinite(hit.t), hit.t, 0.0)[:, None]
                occ_dist = jnp.linalg.norm(occ_pos - surf_pos, axis=-1)
                behind = occ_dist > point_dist
                found = found & ~behind
                uv, simple = orig_uv, orig_simple  # original hit UV/type
            op = texturing.sample_opacity(
                scene, model, uv, simple,
                rows=None if spec.differentiable else walk_row)
            trans = jnp.where(found, trans * (1.0 - op), trans)
            walking = found & (trans != 0.0)
            t_prev = jnp.where(walking, hit.t, t_prev)
            return (k + 1, trans, t_prev, walking)

        return cond, step

    dense = part and _use_dense_tr(scene)
    if dense:
        # Dense column walk (see _alpha_walk_partitioned): producer pass +
        # batched opacity precompute, then a statically-unrolled product
        # over the kk columns; exact cast residual past the cap.
        kk = _dense_k(scene, steps)

        def produce(s_o, s_d):
            ts, pos = _dense_tr_hits(scene, s_o, s_d, steps)
            hit = _dense_hit_columns(scene, s_o, s_d, ts, pos)
            walk_row = _tri_attr(scene, hit)
            model, uv, simple = _hit_model_uv(scene, hit, row=walk_row)
            if point_dist is not None:
                # Original hit's UV/type with the occluder's material
                # (mod.rs:324 quirk), tiled over the kk columns.
                rep = lambda x: jnp.concatenate([x] * kk, axis=0)
                uv, simple = rep(orig_model_uv[0]), rep(orig_model_uv[1])
            op = texturing.sample_opacity(
                scene, model, uv, simple,
                rows=None if spec.differentiable else walk_row)
            return hit.t, op

        tcols, opcols = jax.lax.stop_gradient(jax.lax.cond(
            jnp.any(walking0),
            produce,
            lambda a, b: (jnp.full((kk * r,), jnp.inf, jnp.float32),
                          jnp.zeros((kk * r,), jnp.float32)),
            s_o, s_d))
        tcols = _cols(tcols, kk, r)
        opcols = _cols(opcols, kk, r)

        trans = jnp.ones((r,), jnp.float32)
        t_prev = jnp.full((r,), -1.0, jnp.float32)
        walking = walking0
        for k in range(kk):
            tk = tcols[k]
            found = walking & jnp.isfinite(tk)
            if point_dist is not None:
                occ_pos = s_o + s_d * jnp.where(
                    jnp.isfinite(tk), tk, 0.0)[:, None]
                occ_dist = jnp.linalg.norm(occ_pos - surf_pos, axis=-1)
                found = found & ~(occ_dist > point_dist)
            trans = jnp.where(found, trans * (1.0 - opcols[k]), trans)
            walking = found & (trans != 0.0)
            t_prev = jnp.where(walking, tk, t_prev)
        if kk < steps:
            condf, stepf = cast_step(
                s_o, s_d, point_dist, surf_pos,
                None if orig_model_uv is None else orig_model_uv[0],
                None if orig_model_uv is None else orig_model_uv[1])
            _, trans, _, _ = jax.lax.while_loop(
                condf, stepf, (jnp.int32(kk), trans, t_prev, walking))
        trans = jax.lax.stop_gradient(trans)
    else:
        def run_walk(s_o, s_d, walking0, point_dist, surf_pos, orig_uv,
                     orig_simple):
            rc = s_o.shape[0]
            condf, stepf = cast_step(s_o, s_d, point_dist, surf_pos,
                                     orig_uv, orig_simple)
            init = (jnp.int32(0), jnp.ones((rc,), jnp.float32),
                    jnp.full((rc,), -1.0, jnp.float32), walking0)
            _, trans, _, _ = jax.lax.while_loop(condf, stepf, init)
            return trans

        n_chunks = _walk_chunks(r) if part else 1
        if n_chunks == 1:
            trans = jax.lax.stop_gradient(run_walk(
                s_o, s_d, walking0, point_dist, surf_pos,
                None if orig_model_uv is None else orig_model_uv[0],
                None if orig_model_uv is None else orig_model_uv[1]))
        else:
            ch = lambda x: x.reshape(n_chunks, r // n_chunks,
                                     *x.shape[1:])
            if point_dist is None:
                args = (ch(s_o), ch(s_d), ch(walking0))
                fn = lambda a: run_walk(*a, None, None, None, None)
            else:
                args = (ch(s_o), ch(s_d), ch(walking0), ch(point_dist),
                        ch(surf_pos), ch(orig_model_uv[0]),
                        ch(orig_model_uv[1]))
                fn = lambda a: run_walk(*a)
            trans = jax.lax.stop_gradient(
                jax.lax.map(fn, args)).reshape(r)
    att = att0 * trans[:, None]
    if part:
        att = jnp.where(blocked[:, None], 0.0, att)
    return att


def _shadow_attenuation_multi(scene, s_o, dirs, actives, colors, spec, steps,
                              point_dists, surf_pos, orig_model_uv, blockeds):
    """All L lights' partitioned shadow attenuations in ONE stacked walk.

    The opaque any-hit half comes in as ``blockeds``; this stacks the
    TRANSPARENT transmittance walks: lanes for all L lights
    concatenate into one [L*R] wavefront, so the chunked while_loop and its
    per-iteration cast + gathers launch once instead of L times. Per-lane
    semantics identical to
    _shadow_attenuation: directional lanes sample the occluder's OWN uv and
    have no behind-light cutoff (point_dist = +inf); point lanes use the
    ORIGINAL hit's UV/type (ref mod.rs:324 quirk) and the behind-light
    cutoff from the original surface point.
    """
    from path_tracer_tpu.scene.device_scene import transparent_view

    tv = transparent_view(scene)
    L = len(dirs)
    r = s_o.shape[0]
    att0s = [jnp.where(actives[i][:, None],
                       jnp.broadcast_to(colors[i], s_o.shape), 0.0)
             for i in range(L)]

    inf = jnp.full((r,), jnp.inf, jnp.float32)
    o3 = jnp.concatenate([s_o] * L, axis=0)
    d3 = jnp.concatenate(dirs, axis=0)
    pd3 = jnp.concatenate([inf if point_dists[i] is None else point_dists[i]
                           for i in range(L)], axis=0)
    is_pt = jnp.concatenate(
        [jnp.full((r,), point_dists[i] is not None) for i in range(L)])
    sp3 = jnp.concatenate([surf_pos] * L, axis=0)
    ouv3 = jnp.concatenate([orig_model_uv[0]] * L, axis=0)
    osimple3 = jnp.concatenate([orig_model_uv[1]] * L, axis=0)
    walking0 = jnp.concatenate(
        [actives[i] & ~blockeds[i]
         & (jnp.sum(jnp.abs(att0s[i]), axis=-1) != 0.0) for i in range(L)])
    # Prefilter: shadow segments that miss every transparent cluster have
    # transmittance exactly 1 (t_max = distance-to-light for point lanes,
    # +inf for directional; small conservative margin for the shadow bias).
    walking0 = walking0 & _hits_transparent_bounds(
        scene, o3, d3, pd3 * 1.0001 + 1e-3)

    n = L * r

    def cast_step(s_o, s_d, pd, is_pt, surf_pos, ouv, osimple):
        """(cond, step) of the per-iteration stacked CAST walk."""

        def cond(carry):
            k, trans, t_prev, walking = carry
            return (k < steps) & jnp.any(walking)

        def step(carry):
            k, trans, t_prev, walking = carry
            hit = closest_hit(s_o, s_d, t_prev, tv, block=spec.tri_block,
                              active=walking if scene.use_bvh else None,
                              include_spheres=False)
            found = walking & hit.valid
            walk_row = _tri_attr(scene, hit)
            model, uv, simple = _hit_model_uv(scene, hit, row=walk_row)
            occ_pos = s_o + s_d * jnp.where(
                jnp.isfinite(hit.t), hit.t, 0.0)[:, None]
            occ_dist = jnp.linalg.norm(occ_pos - surf_pos, axis=-1)
            found = found & ~(is_pt & (occ_dist > pd))
            uv = jnp.where(is_pt[:, None], ouv, uv)
            simple = jnp.where(is_pt, osimple, simple)
            op = texturing.sample_opacity(
                scene, model, uv, simple,
                rows=None if spec.differentiable else walk_row)
            trans = jnp.where(found, trans * (1.0 - op), trans)
            walking = found & (trans != 0.0)
            t_prev = jnp.where(walking, hit.t, t_prev)
            return (k + 1, trans, t_prev, walking)

        return cond, step

    dense = _use_dense_tr(scene)
    if dense:
        # Dense column walk over the stacked [L*R] wavefront (see
        # _alpha_walk_partitioned): one producer pass + batched opacity
        # precompute, unrolled column product, exact cast residual.
        kk = _dense_k(scene, steps)

        def produce(o3, d3):
            ts, pos = _dense_tr_hits(scene, o3, d3, steps)
            hit = _dense_hit_columns(scene, o3, d3, ts, pos)
            walk_row = _tri_attr(scene, hit)
            model, uv, simple = _hit_model_uv(scene, hit, row=walk_row)
            rep = lambda x: jnp.concatenate([x] * kk, axis=0)
            uv = jnp.where(rep(is_pt)[:, None], rep(ouv3), uv)
            simple = jnp.where(rep(is_pt), rep(osimple3), simple)
            op = texturing.sample_opacity(
                scene, model, uv, simple,
                rows=None if spec.differentiable else walk_row)
            return hit.t, op

        tcols, opcols = jax.lax.stop_gradient(jax.lax.cond(
            jnp.any(walking0),
            produce,
            lambda a, b: (jnp.full((kk * n,), jnp.inf, jnp.float32),
                          jnp.zeros((kk * n,), jnp.float32)),
            o3, d3))
        tcols = _cols(tcols, kk, n)
        opcols = _cols(opcols, kk, n)

        trans3 = jnp.ones((n,), jnp.float32)
        t_prev = jnp.full((n,), -1.0, jnp.float32)
        walking = walking0
        for k in range(kk):
            tk = tcols[k]
            found = walking & jnp.isfinite(tk)
            occ_pos = o3 + d3 * jnp.where(jnp.isfinite(tk), tk, 0.0)[:, None]
            occ_dist = jnp.linalg.norm(occ_pos - sp3, axis=-1)
            found = found & ~(is_pt & (occ_dist > pd3))
            trans3 = jnp.where(found, trans3 * (1.0 - opcols[k]), trans3)
            walking = found & (trans3 != 0.0)
            t_prev = jnp.where(walking, tk, t_prev)
        if kk < steps:
            condf, stepf = cast_step(o3, d3, pd3, is_pt, sp3, ouv3,
                                     osimple3)
            _, trans3, _, _ = jax.lax.while_loop(
                condf, stepf, (jnp.int32(kk), trans3, t_prev, walking))
        trans3 = jax.lax.stop_gradient(trans3)
    else:
        def run_walk(s_o, s_d, walking0, pd, is_pt, surf_pos, ouv,
                     osimple):
            rc = s_o.shape[0]
            condf, stepf = cast_step(s_o, s_d, pd, is_pt, surf_pos, ouv,
                                     osimple)
            init = (jnp.int32(0), jnp.ones((rc,), jnp.float32),
                    jnp.full((rc,), -1.0, jnp.float32), walking0)
            _, trans, _, _ = jax.lax.while_loop(condf, stepf, init)
            return trans

        n_chunks = _walk_chunks(n)
        args = (o3, d3, walking0, pd3, is_pt, sp3, ouv3, osimple3)
        if n_chunks == 1:
            trans3 = jax.lax.stop_gradient(run_walk(*args))
        else:
            ch = lambda x: x.reshape(n_chunks, n // n_chunks,
                                     *x.shape[1:])
            trans3 = jax.lax.stop_gradient(jax.lax.map(
                lambda a: run_walk(*a),
                tuple(ch(x) for x in args))).reshape(n)

    outs = []
    for i in range(L):
        trans = trans3[i * r : (i + 1) * r]
        att = att0s[i] * trans[:, None]
        outs.append(jnp.where(blockeds[i][:, None], 0.0, att))
    return outs


def render_wavefront(scene, pixel_ids, width: int, height: int, sample_id,
                     spec: IntegratorSpec, rays=None, exchange=None,
                     lane_ids=None, collect_live_counts: bool = False):
    """Trace one sample for a wavefront of pixels. Returns radiance [R,3].

    pixel_ids: [R] int32 (y*width+x). rays optionally overrides camera ray
    generation with (origins, dirs).

    exchange: optional callable applied to the FULL wavefront state tuple
    ``(o, d, color, throughput, alive, pix, orig)`` at the start of every
    bounce — the hook for cross-shard live-ray rebalancing (SURVEY §2c;
    parallel/render.py builds an all_to_all exchange from it). The hook may
    permute lanes arbitrarily, including ACROSS shards: every per-lane RNG
    site keys off the lane's travelling pixel id, so radiance is
    permutation-invariant. With ``exchange`` set, the return value is
    ``(color [R,3], orig [R])`` — lanes are still in exchanged order and
    ``orig`` (seeded from ``lane_ids``, default arange) says where each
    lane's radiance belongs; the caller inverts globally.
    """
    from path_tracer_tpu.ops.camera import generate_rays

    if rays is None:
        o, d = generate_rays(pixel_ids, width, height, scene, sample_id, spec.seed)
    else:
        o, d = rays

    r = o.shape[0]
    color = jnp.zeros((r, 3), jnp.float32)
    throughput = jnp.ones((r, 3), jnp.float32)
    alive = jnp.ones((r,), jnp.bool_)

    # Fully opaque scenes collapse both bounded walks to one cast each.
    # Otherwise the auto bound (num_transparent_hits + 1) reproduces the
    # reference's unbounded walk exactly; explicit spec values truncate.
    auto_steps = getattr(scene, "num_transparent_hits", 0) + 1
    alpha_steps = 1 if scene.all_opaque else (
        spec.alpha_walk_steps if spec.alpha_walk_steps is not None
        else auto_steps)
    shadow_steps = 1 if scene.all_opaque else (
        spec.shadow_walk_steps if spec.shadow_walk_steps is not None
        else auto_steps)

    # The bounce loop is a lax.scan over a single compiled bounce body (the
    # reference unrolls per pixel, src/renderer/mod.rs:180; unrolling here
    # would multiply XLA program size by bounces+1). ``bounce`` is traced:
    # last-bounce/RR behavior is masked, and rng sites offset by it.
    track_origin = spec.compact or exchange is not None
    # PT_REMAT=1: rematerialize each bounce in the backward pass instead of
    # storing its residuals — trades one forward recompute per bounce for
    # the HBM traffic of the scan's saved intermediates (A/B knob for the
    # train-step bench; applied only under AD, a no-op for pure rendering).
    import os as _os

    remat_bounces = (spec.differentiable
                     and _os.environ.get("PT_REMAT") == "1")

    def bounce_body(carry, bounce):
        if track_origin:
            state = carry
            if exchange is not None:
                state = exchange(state)
            else:
                perm = jnp.argsort(~state[4])  # stable: alive lanes first
                state = tuple(x[perm] for x in state)
            o, d, color, throughput, alive, pix, orig = state
        else:
            o, d, color, throughput, alive = carry
            pix = pixel_ids
        # Per-bounce live-lane count BEFORE this bounce's casts — the
        # quantity cross-shard rebalancing equalizes (SCALING_r05 imbalance
        # histograms; VERDICT r4 next #6).
        live_in = jnp.sum(alive.astype(jnp.int32)) if collect_live_counts \
            else None
        sel, seen_any, first_missed = _alpha_walk(
            scene, o, d, alive, pix, sample_id, bounce, spec, alpha_steps
        )

        # Background: only rays whose first cast this bounce missed everything.
        color = jnp.where((first_missed)[:, None],
                          color + throughput * scene.background, color)
        alive = alive & ~first_missed

        row = _tri_attr(scene, sel)
        surf = _surface(scene, sel, o, d, row=row,
                        differentiable=spec.differentiable)
        mat = texturing.sample_material(
            scene, surf.model, surf.uv, surf.simple,
            rows=None if spec.differentiable else row)
        f0 = brdf.compute_f0(mat.metalness, mat.albedo)
        view = -d

        # Emissive (mod.rs:245)
        color = jnp.where(alive[:, None], color + throughput * mat.emissive, color)

        shadow_o = surf.pos + surf.geom_normal * NORMAL_BIAS

        # A lane facing AWAY from a light contributes exactly zero UNLESS its
        # hit material is emissive (both BRDF terms carry max(n.l, 0); the
        # only surviving eval_direct term is the emissive-in-eval_direct
        # quirk, cook_torrance.rs:57, which needs the light's attenuated
        # radiance) — skip the shadow cast for facing-away non-emissive
        # lanes. On closed geometry this kills ~half the lanes per light and
        # whole Morton tiles exit the occlusion walk immediately.
        if scene.no_emissive:
            emissive_lane = None
        else:
            emissive_lane = jnp.sum(jnp.abs(mat.emissive), axis=-1) != 0.0

        def shadow_active(l_dir):
            facing = _dot(surf.normal, l_dir) > 0.0
            if emissive_lane is not None:
                facing = facing | emissive_lane
            return alive & facing

        # Point-light geometry precomputed once; shared by the batched
        # occlusion call and the shading loop below.
        pt_dirs, pt_dists = [], []
        for li in range(scene.num_point_lights):
            to_surf = surf.pos - scene.point_pos[li]
            dist = jnp.linalg.norm(to_surf, axis=-1)
            pt_dirs.append(to_surf / dist[:, None])  # light → surface
            pt_dists.append(dist)

        # Fully opaque scenes: every light's any-hit query up front.
        # Partitioned mixed-opacity scenes query the OPAQUE subset the same
        # way (the binary half of the partitioned attenuation walk).
        from path_tracer_tpu.scene.device_scene import (
            opaque_view,
            partitioned,
        )

        blocked_all = None
        n_lights = scene.num_dir_lights + scene.num_point_lights
        part = partitioned(scene)
        if (scene.all_opaque or part) and n_lights > 1:
            dirs_all, dists_all, act_all = [], [], []
            for li in range(scene.num_dir_lights):
                sd = jnp.broadcast_to(-scene.dir_dir[li], d.shape)
                dirs_all.append(sd)
                dists_all.append(None)
                act_all.append(shadow_active(sd))
            for li in range(scene.num_point_lights):
                dirs_all.append(-pt_dirs[li])
                dists_all.append(pt_dists[li])
                act_all.append(shadow_active(-pt_dirs[li]))
            from path_tracer_tpu.ops.intersect import occluded

            blocked_all = [
                occluded(shadow_o, sd, opaque_view(scene) if part else scene,
                         surf_pos=surf.pos, max_dist=md,
                         block=spec.tri_block, active=act)
                for sd, md, act in zip(dirs_all, dists_all, act_all)]

        # Partitioned mixed-opacity scenes additionally run ALL lights'
        # transparent transmittance walks as ONE stacked chunked walk
        # (_shadow_attenuation_multi).
        att_pre = None
        if part and blocked_all is not None and not scene.all_opaque:
            colors_all = ([scene.dir_color[li]
                           for li in range(scene.num_dir_lights)]
                          + [1.0] * scene.num_point_lights)
            att_pre = _shadow_attenuation_multi(
                scene, shadow_o, dirs_all, act_all, colors_all, spec,
                shadow_steps, dists_all, surf.pos, (surf.uv, surf.simple),
                blocked_all)

        # Directional lights (mod.rs:283-299): static python loop.
        for li in range(scene.num_dir_lights):
            ldir = scene.dir_dir[li]  # raw, possibly unnormalized — as in ref
            if att_pre is not None:
                radiance = att_pre[li]
            else:
                radiance = _shadow_attenuation(
                    scene, shadow_o, jnp.broadcast_to(-ldir, d.shape),
                    shadow_active(jnp.broadcast_to(-ldir, d.shape)),
                    scene.dir_color[li], spec, shadow_steps,
                    blocked=None if blocked_all is None else blocked_all[li],
                )
            lit = alive & (jnp.sum(radiance, axis=-1) != 0.0)  # skip zero lights
            ev = brdf.eval_direct(mat, f0, surf.normal, view,
                                  jnp.broadcast_to(-ldir, d.shape))
            color = jnp.where(lit[:, None], color + throughput * ev * radiance,
                              color)

        # Point lights (mod.rs:301-331).
        for li in range(scene.num_point_lights):
            dist = pt_dists[li]
            ldir = pt_dirs[li]  # light → surface
            dissipated = scene.point_color[li] / (4.0 * PI * dist * dist)[:, None]
            if att_pre is not None:
                radiance = att_pre[scene.num_dir_lights + li] * dissipated
            else:
                radiance = _shadow_attenuation(
                    scene, shadow_o, -ldir, shadow_active(-ldir), 1.0, spec,
                    shadow_steps,
                    point_dist=dist, surf_pos=surf.pos,
                    orig_model_uv=(surf.uv, surf.simple),
                    blocked=None if blocked_all is None
                    else blocked_all[scene.num_dir_lights + li],
                ) * dissipated
            lit = alive & (jnp.sum(radiance, axis=-1) != 0.0)
            ev = brdf.eval_direct(mat, f0, surf.normal, view, -ldir)
            color = jnp.where(lit[:, None], color + throughput * ev * radiance,
                              color)

        # Indirect bounce (mod.rs:264-275), masked out on the last bounce
        # (ref passes compute_indirect = bounce < bounces, mod.rs:216).
        indirect = alive & (bounce < spec.bounces)
        s_g1, s_g2, s_rr, s_stride = rng.site_layout(alpha_steps)
        r1 = rng.uniform(pix, sample_id,
                         s_g1 + s_stride * bounce, spec.seed)
        r2 = rng.uniform(pix, sample_id,
                         s_g2 + s_stride * bounce, spec.seed)
        new_d, wm = brdf.sample(mat, surf.normal, view, r1, r2)
        # Detached sampling: gradients flow through eval_indirect's explicit
        # material dependence, not through the sampled direction
        # (discrete-event detach; SURVEY §7).
        new_d = jax.lax.stop_gradient(new_d)
        wm = jax.lax.stop_gradient(wm)
        ind = brdf.eval_indirect(mat, f0, surf.normal, view, new_d, wm)
        throughput = jnp.where(indirect[:, None], throughput * ind, throughput)
        o = jnp.where(indirect[:, None],
                      surf.pos + surf.geom_normal * NORMAL_BIAS, o)
        d = jnp.where(indirect[:, None], new_d, d)
        alive = alive & (bounce < spec.bounces)

        # Throughput cutoff (mod.rs:219)
        alive = alive & (_dot(throughput, throughput) >= THROUGHPUT_CUTOFF)

        # Russian roulette for bounce > 3 (mod.rs:223, utils.rs:23-31):
        # T /= p unconditionally, kill when rand > p. (A kill or division
        # after the FINAL bounce is a no-op in the reference — the loop
        # exits — so masking with `alive`, already false past the last
        # bounce, preserves semantics.)
        rr = alive & (bounce > 3)
        p = jnp.max(throughput, axis=-1)
        p_safe = jnp.where(rr, jnp.maximum(p, 1e-30), 1.0)
        throughput = jnp.where(rr[:, None], throughput / p_safe[:, None],
                               throughput)
        rnd = rng.uniform(pix, sample_id,
                          s_rr + s_stride * bounce, spec.seed)
        alive = alive & ~(rr & (rnd > p))

        if track_origin:
            return (o, d, color, throughput, alive, pix, orig), live_in
        return (o, d, color, throughput, alive), live_in

    body = jax.checkpoint(bounce_body) if remat_bounces else bounce_body
    if track_origin:
        orig0 = (lane_ids if lane_ids is not None
                 else jnp.arange(r, dtype=jnp.int32))
        init = (o, d, color, throughput, alive, pixel_ids, orig0)
        (_, _, color, _, _, _, orig), live = jax.lax.scan(
            body, init, jnp.arange(spec.bounces + 1, dtype=jnp.int32)
        )
        if exchange is not None:
            out = (color, orig)  # caller inverts the placement
        else:
            out = jnp.zeros_like(color).at[orig].set(color)
        return (out, live) if collect_live_counts else out
    init = (o, d, color, throughput, alive)
    (o, d, color, throughput, alive), live = jax.lax.scan(
        body, init, jnp.arange(spec.bounces + 1, dtype=jnp.int32)
    )
    return (color, live) if collect_live_counts else color
