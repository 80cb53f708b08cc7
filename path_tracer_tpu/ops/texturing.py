"""Texture fetch + material sampling for a hit wavefront.

Parity with the reference's Material getters (src/scene/internal/material.rs):
- Nearest-neighbor fetch: texel = (trunc(u*W) rem_euclid W, trunc(v*H) rem_euclid H)
  (material.rs:115-130; Rust `as i64` truncates toward zero, then rem_euclid).
- Albedo texture is sRGB→linear via pow 2.2 then multiplied by the factor
  (material.rs:137-141); the emissive texture is NOT linearized
  (material.rs:189-201 — reference quirk, reproduced).
- Gray channels multiply texel by factor (material.rs:152-176, 207-214).
- Normal maps decode texel*2-1, i.e. px/127.5-1 (material.rs:178-187).
- Sphere hits use factor-only "simple" samples (material_sample.rs:31-40).
- roughness is clamped to >= 1e-4 (material_sample.rs:23).

Gather economics: each [R]-indexed gather pays a per-lane latency that
barely depends on row width, so sampling cost is counted in GATHERS.
The rows-based paths (baked sl_attr columns) fetch a texel with exactly ONE
atlas gather — the texture id, factor, and the atlas offset/width/height all
ride the wide row gather the caller already paid for (ATTR_*_G columns,
scene.attr_tex_baked). Channels no model textures (scene.has_tex flags)
skip their atlas gather statically.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from path_tracer_tpu.scene.device_scene import (
    ATTR_ALBEDO_F, ATTR_ALBEDO_G, ATTR_ALBEDO_T, ATTR_EMISSIVE_F,
    ATTR_EMISSIVE_G, ATTR_EMISSIVE_T, ATTR_IOR, ATTR_METAL_F, ATTR_METAL_G,
    ATTR_METAL_T, ATTR_NORMAL_G, ATTR_NORMAL_T, ATTR_OPACITY_F,
    ATTR_OPACITY_G, ATTR_OPACITY_T, ATTR_ROUGH_F, ATTR_ROUGH_G, ATTR_ROUGH_T,
    ATTR_WIDE_G, WIDE_ALBEDO, WIDE_EMISSIVE, WIDE_METAL, WIDE_NORMAL,
    WIDE_OPACITY, WIDE_ROUGH,
)

# has_tex tuple positions (device_scene.DeviceScene.has_tex)
_ALBEDO, _EMISSIVE, _OPACITY, _METAL, _ROUGH, _NORMAL = range(6)


def _texel_index(uv, w, h):
    """Flat texel offset for nearest-neighbor wrap sampling (w/h [R] i32)."""
    # trunc toward zero (Rust `as i64`), then rem_euclid
    ix = jnp.astype(uv[:, 0] * w.astype(jnp.float32), jnp.int32)
    iy = jnp.astype(uv[:, 1] * h.astype(jnp.float32), jnp.int32)
    ix = jnp.mod(ix, w)
    iy = jnp.mod(iy, h)
    return iy * w + ix


def _fetch(scene, tex_id, uv):
    """Raw texel [R,3] via the offset/size TABLES (non-rows path; 4 gathers)."""
    tid = jnp.maximum(tex_id, 0)
    w = scene.tex_width[tid]
    h = scene.tex_height[tid]
    off = scene.tex_offset[tid]
    return scene.tex_data[off + _texel_index(uv, w, h)]


def _fetch_rows(scene, rows, gcol, uv):
    """Raw texel [R,3] via BAKED atlas geometry (ONE atlas gather)."""
    off = rows[:, gcol].astype(jnp.int32)
    w = rows[:, gcol + 1].astype(jnp.int32)
    h = rows[:, gcol + 2].astype(jnp.int32)
    return scene.tex_data[off + _texel_index(uv, w, h)]


def _rows_texel(scene, rows, tcol, gcol, uv):
    """Rows-path texel fetch: baked geometry when valid, else table fetch."""
    if getattr(scene, "attr_tex_baked", False):
        return _fetch_rows(scene, rows, gcol, uv)
    return _fetch(scene, rows[:, tcol].astype(jnp.int32), uv)


_WIDE_COL = {_ALBEDO: WIDE_ALBEDO, _EMISSIVE: WIDE_EMISSIVE,
             _OPACITY: WIDE_OPACITY, _METAL: WIDE_METAL,
             _ROUGH: WIDE_ROUGH, _NORMAL: WIDE_NORMAL}


def _wide(scene, channel: int) -> bool:
    """Channel rides the one wide-texel gather (build-time static)."""
    return (not scene.no_textures
            and bool(getattr(scene, "wide_covered", (False,) * 6)[channel]))


def _wide_texels(scene, rows, uv):
    """ONE [R, WIDE_COLS] gather fetching every covered channel's texel
    (tex_wide holds the SAME texel values as the per-channel atlas planes,
    channel-interleaved per material — device_scene._build_wide_tex)."""
    off = rows[:, ATTR_WIDE_G].astype(jnp.int32)
    w = rows[:, ATTR_WIDE_G + 1].astype(jnp.int32)
    h = rows[:, ATTR_WIDE_G + 2].astype(jnp.int32)
    return scene.tex_wide[off + _texel_index(uv, w, h)]


def _has(scene, channel: int) -> bool:
    if scene.no_textures:
        return False
    flags = getattr(scene, "has_tex", None)
    return True if flags is None else bool(flags[channel])


def sample_rgb(scene, tex_id, uv, factor, simple, linearize: bool,
               texel=None):
    """Channel3 sample [R,3]. simple: [R] bool — factor-only (sphere hits).
    ``texel``: optionally a pre-fetched raw texel (rows path)."""
    if texel is None:
        texel = _fetch(scene, tex_id, uv)
    if linearize:
        texel = jnp.power(texel, 2.2)
    textured = texel * factor
    use_factor = simple | (tex_id < 0)
    return jnp.where(use_factor[:, None], factor, textured)


def sample_gray(scene, tex_id, uv, factor, simple, texel=None):
    """Channel1 sample [R]."""
    if texel is None:
        texel = _fetch(scene, tex_id, uv)
    use_factor = simple | (tex_id < 0)
    return jnp.where(use_factor, factor, texel[:, 0] * factor)


class MaterialSample(NamedTuple):
    """Point-sampled material (ref: material_sample.rs:8-41)."""

    albedo: jnp.ndarray  # [R,3]
    emissive: jnp.ndarray  # [R,3]
    opacity: jnp.ndarray  # [R]
    metalness: jnp.ndarray  # [R]
    roughness: jnp.ndarray  # [R] clamped >= 1e-4
    ior: jnp.ndarray  # [R]


def sample_opacity(scene, model_id, uv, simple, rows=None):
    """Opacity only — the alpha walk's accept test needs nothing else.

    ``rows``: optional pre-gathered sl_attr rows; factors, texture ids, and
    (attr_tex_baked) the atlas geometry then come from the baked ATTR_*
    columns — ONE atlas gather total (forward rendering only — baked
    factors carry no gradients).
    """
    if rows is not None:
        factor = rows[:, ATTR_OPACITY_F]
        if not _has(scene, _OPACITY):
            return factor
        tid = rows[:, ATTR_OPACITY_T].astype(jnp.int32)
        if _wide(scene, _OPACITY):
            texel = _wide_texels(scene, rows, uv)[:, WIDE_OPACITY:
                                                  WIDE_OPACITY + 3]
        else:
            texel = _rows_texel(scene, rows, ATTR_OPACITY_T, ATTR_OPACITY_G,
                                uv)
        return sample_gray(scene, tid, uv, factor, simple, texel=texel)
    if not _has(scene, _OPACITY):
        return scene.mat_opacity_factor[model_id]
    return sample_gray(
        scene, scene.mat_opacity_tex[model_id], uv,
        scene.mat_opacity_factor[model_id], simple,
    )


def sample_material(scene, model_id, uv, simple, rows=None) -> MaterialSample:
    """Full material sample. ``rows`` (optional): baked sl_attr rows replace
    every model-indexed factor/texture-id gather — and, with
    attr_tex_baked, every offset/size table gather — with column slices of
    the one wide row gather (non-differentiable render path only)."""
    if rows is not None:
        ti = lambda c: rows[:, c].astype(jnp.int32)
        # Channels the wide table covers share ONE texel gather.
        texw = (_wide_texels(scene, rows, uv)
                if any(_has(scene, c) and _wide(scene, c)
                       for c in (_ALBEDO, _EMISSIVE, _OPACITY, _METAL,
                                 _ROUGH))
                else None)

        def texel_of(tcol, gcol, channel):
            if _wide(scene, channel):
                c = _WIDE_COL[channel]
                # col:col+3 serves both kinds: rgb channels own 3 columns;
                # gray samplers read texel[:, 0] only (tail slices clamp).
                return texw[:, c:c + 3]
            return _rows_texel(scene, rows, tcol, gcol, uv)

        def rgb(tcol, gcol, fcols, channel, linearize):
            factor = rows[:, fcols:fcols + 3]
            if not _has(scene, channel):
                return factor
            texel = texel_of(tcol, gcol, channel)
            return sample_rgb(scene, ti(tcol), uv, factor, simple,
                              linearize=linearize, texel=texel)

        def gray(tcol, gcol, fcol, channel):
            factor = rows[:, fcol]
            if not _has(scene, channel):
                return factor
            texel = texel_of(tcol, gcol, channel)
            return sample_gray(scene, ti(tcol), uv, factor, simple,
                               texel=texel)

        return MaterialSample(
            albedo=rgb(ATTR_ALBEDO_T, ATTR_ALBEDO_G, ATTR_ALBEDO_F,
                       _ALBEDO, True),
            emissive=rgb(ATTR_EMISSIVE_T, ATTR_EMISSIVE_G, ATTR_EMISSIVE_F,
                         _EMISSIVE, False),
            opacity=gray(ATTR_OPACITY_T, ATTR_OPACITY_G, ATTR_OPACITY_F,
                         _OPACITY),
            metalness=gray(ATTR_METAL_T, ATTR_METAL_G, ATTR_METAL_F, _METAL),
            roughness=jnp.maximum(
                gray(ATTR_ROUGH_T, ATTR_ROUGH_G, ATTR_ROUGH_F, _ROUGH), 1e-4),
            ior=rows[:, ATTR_IOR],
        )

    m = model_id

    def rgb_m(tex_tab, fac_tab, channel, linearize):
        factor = fac_tab[m]
        if not _has(scene, channel):
            return factor
        return sample_rgb(scene, tex_tab[m], uv, factor, simple,
                          linearize=linearize)

    def gray_m(tex_tab, fac_tab, channel):
        factor = fac_tab[m]
        if not _has(scene, channel):
            return factor
        return sample_gray(scene, tex_tab[m], uv, factor, simple)

    return MaterialSample(
        albedo=rgb_m(scene.mat_albedo_tex, scene.mat_albedo_factor,
                     _ALBEDO, True),
        emissive=rgb_m(scene.mat_emissive_tex, scene.mat_emissive_factor,
                       _EMISSIVE, False),
        opacity=gray_m(scene.mat_opacity_tex, scene.mat_opacity_factor,
                       _OPACITY),
        metalness=gray_m(scene.mat_metalness_tex, scene.mat_metalness_factor,
                         _METAL),
        roughness=jnp.maximum(
            gray_m(scene.mat_roughness_tex, scene.mat_roughness_factor,
                   _ROUGH), 1e-4),
        ior=scene.mat_ior[m],
    )


def sample_normal_map(scene, model_id, uv, rows=None):
    """Decoded normal-map vector [R,3] (texel*2-1) and a has-map mask.

    Returns (None, None) when NO material has a normal texture — the caller
    skips the whole TBN branch statically."""
    if not _has(scene, _NORMAL):
        return None, None
    if rows is not None:
        tex_id = rows[:, ATTR_NORMAL_T].astype(jnp.int32)
        if _wide(scene, _NORMAL):
            texel = _wide_texels(scene, rows, uv)[:, WIDE_NORMAL:WIDE_NORMAL
                                                  + 3]
        else:
            texel = _rows_texel(scene, rows, ATTR_NORMAL_T, ATTR_NORMAL_G,
                                uv)
    else:
        tex_id = scene.mat_normal_tex[model_id]
        texel = _fetch(scene, tex_id, uv)
    return texel * 2.0 - 1.0, tex_id >= 0
