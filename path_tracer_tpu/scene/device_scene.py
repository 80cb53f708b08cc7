"""Device scene: flat SoA arrays for the wavefront renderer.

This replaces the reference's pointer-rich runtime scene
(ref: src/scene/internal/mod.rs:25-51, model.rs:10-21) with a single pytree of
padded, fixed-shape arrays — the layout XLA and the kernels want:

- All mesh triangles of all models are flattened into ONE global triangle
  array (the reference's two-level Model enum split is an artifact of its
  KD-tree crate; a flat SoA + per-triangle material id is strictly more
  wavefront-friendly). Precomputed per triangle: v0, edge1, edge2 (Möller-Trumbore
  operands, ref triangle.rs:43-44), vertex normals, UVs, and the per-triangle
  tangent (constant across the face — ref hit.rs:116-127 recomputes it per
  hit, but it only depends on edges and UV deltas).
- Analytic spheres in their own small SoA (ref model.rs:26-63).
- Materials as per-model factor tables + texture ids (-1 = no texture),
  mirroring the 5-channel factor x texture model (ref material.rs:10-26).
- All textures packed into one flat RGB f32 atlas with an offset/size table;
  nearest-neighbor wrap sampling happens in ops.texturing.
- Lights split by type into fixed arrays (counts are static per scene).

Padding: triangles are padded with degenerate (all-zero) entries — their
Möller-Trumbore determinant is 0, which the det cutoff rejects
(ref triangle.rs:49). Spheres are padded with far-away centers so the
discriminant is negative. Every array keeps a static shape so one compiled
executable serves the whole render.
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional

import jax
import numpy as np

from path_tracer_tpu.scene import isf
from path_tracer_tpu.utils.image_io import load_texture_gray, load_texture_rgb

_TRI_PAD = 256  # triangle count padded to a multiple of this (scan block)


def _pad_to(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


# Wide shading-attribute row layout (DeviceScene.sl_attr, one row per packed
# triangle slot plus one row per sphere). Columns 0-28 are geometry/ids;
# 29+ bake the row's MATERIAL (factors + texture ids) so the forward render
# needs a single gather per bounce. Texture ids are stored as float (small
# ints, exact in f32). Columns 45+ additionally bake each channel's texture
# ATLAS GEOMETRY (offset, width, height): a texel fetch then needs only the
# row gather + ONE atlas gather instead of three extra tiny-table gathers
# per channel. Offsets are exact in f32 up to
# 2^24 atlas texels; bigger atlases clear attr_tex_baked and fall back to
# the table gathers.
ATTR_W = 68
ATTR_ALBEDO_F = 29      # 29:32  albedo factor rgb
ATTR_EMISSIVE_F = 32    # 32:35  emissive factor rgb
ATTR_OPACITY_F = 35
ATTR_METAL_F = 36
ATTR_ROUGH_F = 37
ATTR_IOR = 38
ATTR_ALBEDO_T = 39
ATTR_EMISSIVE_T = 40
ATTR_OPACITY_T = 41
ATTR_METAL_T = 42
ATTR_ROUGH_T = 43
ATTR_NORMAL_T = 44
# Per-channel (offset, width, height) triples; +0 = atlas row offset,
# +1 = width, +2 = height. Texture-free channels bake (0, 1, 1).
ATTR_ALBEDO_G = 45
ATTR_EMISSIVE_G = 48
ATTR_OPACITY_G = 51
ATTR_METAL_G = 54
ATTR_ROUGH_G = 57
ATTR_NORMAL_G = 60
# WIDE-TEXEL geometry (64:67): offset/width/height into tex_wide, the
# channel-interleaved per-material atlas — ONE row gather fetches EVERY
# covered channel's texel (tex_wide column layout: WIDE_* below).
ATTR_WIDE_G = 64
WIDE_ALBEDO = 0   # 0:3
WIDE_EMISSIVE = 3  # 3:6
WIDE_NORMAL = 6   # 6:9
WIDE_OPACITY = 9
WIDE_METAL = 10
WIDE_ROUGH = 11
WIDE_COLS = 12


def _build_wide_tex(mats, atlas_data, offsets, widths, heights):
    """Channel-interleaved texel table: for each material whose textured
    channels all share one (w, h), a [w*h, WIDE_COLS] block holding every
    channel's texels side by side — the shading path then fetches ALL
    channels with ONE row gather instead of one atlas gather per channel
    (gathers cost ~the same regardless of row width; sampling cost is
    gather COUNT). Texels are COPIED from the same atlas planes, so values
    are bit-identical to the per-channel fetches.

    Returns (tex_wide [Nw, WIDE_COLS] f32, woff/ww/wh per-model arrays,
    covered 6-tuple). covered[c] is True when EVERY model with a texture
    on channel c got a wide block — only then may the sampler skip
    channel c's individual fetch statically. Blocks are deduped by the
    model's full texture-id tuple."""
    keys = ("albedo_t", "emissive_t", "opacity_t", "metal_t", "rough_t",
            "normal_t")
    cols = (WIDE_ALBEDO, WIDE_EMISSIVE, WIDE_OPACITY, WIDE_METAL,
            WIDE_ROUGH, WIDE_NORMAL)
    n_models = len(mats["albedo_t"])
    tids = np.stack([np.asarray(mats[k], np.int64) for k in keys], axis=1)
    woff = np.zeros(n_models, np.int64)
    ww = np.ones(n_models, np.int64)
    wh = np.ones(n_models, np.int64)
    # in_wide[m, c]: channel c of model m rides the model's wide block.
    # Channels at a model's PRIMARY texture size (the size most of its
    # textured channels share; ties -> smaller area) form the block; other
    # sizes keep their individual fetches (e.g. a 1024^2 albedo next to
    # 512^2 normal+roughness: the 512^2 pair rides wide, albedo does not).
    in_wide = np.zeros((n_models, 6), bool)
    blocks: dict[tuple, tuple] = {}
    chunks = [np.zeros((1, WIDE_COLS), np.float32)]  # row 0: dummy texel
    nxt = 1
    # Budget in BYTES (ADVICE r4: the old 2^23-ROW default allowed ~400 MB
    # of duplicated texels). 96 MB default; PT_WIDE_TEX_MAX still overrides
    # as a raw row count for sweeps.
    budget = int(float(os.environ.get("PT_WIDE_TEX_MAX_MB", "96"))
                 * (1 << 20) / (4 * WIDE_COLS))
    if "PT_WIDE_TEX_MAX" in os.environ:
        budget = int(os.environ["PT_WIDE_TEX_MAX"])
    for m in range(n_models):
        tex = [(c, int(t)) for c, t in enumerate(tids[m]) if t >= 0]
        if not tex:
            continue
        by_size: dict[tuple, list] = {}
        for c, t in tex:
            by_size.setdefault((int(widths[t]), int(heights[t])),
                               []).append((c, t))
        (w, h), grp = max(by_size.items(),
                          key=lambda kv: (len(kv[1]), -kv[0][0] * kv[0][1]))
        key = tuple(t if (c, t) in grp else -1 for c, t in
                    zip(range(6), tids[m]))
        if key not in blocks:
            if nxt + w * h > budget:
                continue
            blk = np.zeros((w * h, WIDE_COLS), np.float32)
            for c, t in grp:
                off = int(offsets[t])
                plane = atlas_data[off : off + w * h]
                wc = cols[c]
                if c in (0, 1, 5):  # rgb channels
                    blk[:, wc : wc + 3] = plane
                else:  # gray channels read texel[:, 0]
                    blk[:, wc] = plane[:, 0]
            blocks[key] = (nxt, w, h)
            chunks.append(blk)
            nxt += w * h
        woff[m], ww[m], wh[m] = blocks[key]
        for c, _ in grp:
            in_wide[m, c] = True
    covered = tuple(
        bool(np.any(tids[:, c] >= 0))
        and bool(np.all(in_wide[tids[:, c] >= 0, c]))
        for c in range(6))
    return (np.concatenate(chunks, axis=0), woff, ww, wh, covered)


def _bake_material_rows(attr: np.ndarray, model_ids: np.ndarray, mats,
                        atlas=None, wide=None) -> None:
    """Fill ATTR_* material columns of ``attr`` from per-model tables.

    ``atlas``: optional (offsets, widths, heights) arrays indexed by texture
    id — bakes each channel's atlas geometry into its ATTR_*_G triple
    (texture-free channels get (0, 1, 1): offset 0 is the dummy texel)."""
    af = np.asarray(mats["albedo_f"], np.float32).reshape(-1, 3)
    ef = np.asarray(mats["emissive_f"], np.float32).reshape(-1, 3)
    attr[:, ATTR_ALBEDO_F:ATTR_ALBEDO_F + 3] = af[model_ids]
    attr[:, ATTR_EMISSIVE_F:ATTR_EMISSIVE_F + 3] = ef[model_ids]
    attr[:, ATTR_OPACITY_F] = np.asarray(mats["opacity_f"], np.float32)[model_ids]
    attr[:, ATTR_METAL_F] = np.asarray(mats["metal_f"], np.float32)[model_ids]
    attr[:, ATTR_ROUGH_F] = np.asarray(mats["rough_f"], np.float32)[model_ids]
    attr[:, ATTR_IOR] = np.asarray(mats["ior"], np.float32)[model_ids]
    channels = ((ATTR_ALBEDO_T, ATTR_ALBEDO_G, "albedo_t"),
                (ATTR_EMISSIVE_T, ATTR_EMISSIVE_G, "emissive_t"),
                (ATTR_OPACITY_T, ATTR_OPACITY_G, "opacity_t"),
                (ATTR_METAL_T, ATTR_METAL_G, "metal_t"),
                (ATTR_ROUGH_T, ATTR_ROUGH_G, "rough_t"),
                (ATTR_NORMAL_T, ATTR_NORMAL_G, "normal_t"))
    for tcol, gcol, key in channels:
        tids = np.asarray(mats[key], np.int32)[model_ids]
        attr[:, tcol] = tids.astype(np.float32)
        if atlas is not None:
            offs, ws, hs = atlas
            safe = np.maximum(tids, 0)
            has = tids >= 0
            attr[:, gcol] = np.where(has, np.asarray(offs)[safe], 0)
            attr[:, gcol + 1] = np.where(has, np.asarray(ws)[safe], 1)
            attr[:, gcol + 2] = np.where(has, np.asarray(hs)[safe], 1)
    if wide is not None:
        woff, ww, wh = wide
        attr[:, ATTR_WIDE_G] = woff[model_ids]
        attr[:, ATTR_WIDE_G + 1] = ww[model_ids]
        attr[:, ATTR_WIDE_G + 2] = wh[model_ids]


def _baldwin_weber_rows(sl_tris: np.ndarray) -> np.ndarray:
    """[12, n] lane-major Baldwin-Weber rows from packed (v0,e1,e2) rows.

    t = (c - o.n)/(d.n) with n = e1 x e2, c = v0.n (so d.n = -MT det: same
    DET_EPS reject and backface-sign semantics); u = Au.h + au and
    v = Av.h + av on the hit point h = o + t d, with Au = (e2 x n)/(n.n),
    Av = (n x e1)/(n.n). Computed in f64 so the constants carry full f32
    accuracy. Degenerate (padding) rows get all-zero rows: d.n = 0 rejects.
    """
    v0 = sl_tris[:, 0:3].astype(np.float64)
    e1 = sl_tris[:, 3:6].astype(np.float64)
    e2 = sl_tris[:, 6:9].astype(np.float64)
    n = np.cross(e1, e2)
    nn = (n * n).sum(axis=1, keepdims=True)
    inv = np.where(nn > 0.0, 1.0 / np.where(nn > 0.0, nn, 1.0), 0.0)
    au3 = np.cross(e2, n) * inv
    av3 = np.cross(n, e1) * inv
    # 16 rows (12 used + 4 zero).
    out = np.zeros((16, sl_tris.shape[0]), np.float32)
    out[0:3] = n.T
    out[3] = (v0 * n).sum(axis=1)
    out[4:7] = au3.T
    out[7] = -(au3 * v0).sum(axis=1)
    out[8:11] = av3.T
    out[11] = -(av3 * v0).sum(axis=1)
    return out


def _build_tr_walk_tables(sl_bw, sl_attr, sl_tris, nblk_op, n_blocks,
                          block, atlas_data, offsets, widths, heights):
    """Compact transparent-partition tables, built for the fused in-kernel
    walks, which have since been removed (PERF.md Findings). No code path
    reads them now; they
    stay as data until the layout clean-up (ROADMAP Design 2).

    Returns (tr_bw [16,Tp], tr_rows [9,Tp], tr_grp [7,GP], colmap, modelmap,
    tex8 [Hp,Wp] u8-values-as-f32, lut [1,256], pages, textured, ok).
    ``ok`` is False (placeholders returned) unless: the scene HAS a
    transparent partition, it is small enough to keep resident in fast
    memory, its models reference at most PT_TRWALK_PAGES (default 8)
    distinct opacity textures, the stacked texture pages fit, and each
    texture's f32 atlas data is EXACTLY u8/255 (always true for PNG-sourced
    textures; verified here so the in-kernel u8 + LUT fetch is bit-identical
    to the XLA gather fetch).

    MULTI-TEXTURE scenes (the reference fetches opacity from ANY
    per-material texture — src/scene/internal/material.rs:115-130) stack
    each distinct opacity texture as a PAGE of one [Hp, Wp] plane: page p
    occupies rows [ybase_p, ybase_p + h_p), Wp = max padded width. Row 8 of
    tr_rows carries each column's page index; ``pages`` is the static tuple
    of (atlas_offset, w, h, ybase) per page.

    Columns are MORTON-SORTED by triangle centroid so each 128-column group
    is a tight spatial cluster; tr_grp rows 0-5 hold each group's AABB
    (over full triangle extents) and row 6 a valid flag, so a walk can skip
    groups whose AABB a ray segment misses.
    """
    lut = (np.arange(256).astype(np.float64) / 255.0).astype(np.float32)
    lut_row = lut[None, :]
    placeholder = (np.zeros((16, 128), np.float32),
                   np.zeros((9, 128), np.float32),
                   np.zeros((7, 128), np.float32),
                   np.zeros(128, np.int32),
                   np.zeros(128, np.int32),
                   np.zeros((8, 128), np.float32), lut_row, (),
                   False, False)
    lo, hi = nblk_op * block, n_blocks * block
    if hi - lo <= 0:
        return placeholder
    attr_all = sl_attr[lo:hi]
    # COMPACT to the real transparent slots (SAH blocks average ~76% fill;
    # the dense per-iteration visit scales with the column count, so pad
    # slots are pure waste). tr_colmap maps a compact column back to its
    # GLOBAL packed slot id for hit records.
    real = np.abs(attr_all[:, 3:9]).sum(axis=1) > 0
    idx = np.nonzero(real)[0]
    tp = len(idx)
    if tp == 0 or tp > int(os.environ.get("PT_TRWALK_MAX", "4096")):
        return placeholder
    # Morton-sort the compact columns by triangle centroid: spatially
    # coherent 128-column groups make per-group pruning effective (the
    # packed model-emission order scatters foliage cards across the whole
    # table).
    tris = sl_tris[lo:hi][idx]
    v0 = tris[:, 0:3]
    v1 = v0 + tris[:, 3:6]
    v2 = v0 + tris[:, 6:9]
    cen = (v0 + v1 + v2) / 3.0
    mn = cen.min(axis=0)
    # UNIFORM scale (largest extent): per-axis normalization would stretch
    # a thin axis (e.g. foliage height) to full Morton weight and scramble
    # the spatial clusters the groups exist to capture.
    ext = max(float((cen.max(axis=0) - mn).max()), 1e-12)
    q = np.clip((cen - mn) / ext * 1023.0, 0, 1023).astype(np.int64)

    def spread(b):  # interleave 10 bits with 2-bit gaps
        b = (b | (b << 16)) & 0x030000FF
        b = (b | (b << 8)) & 0x0300F00F
        b = (b | (b << 4)) & 0x030C30C3
        b = (b | (b << 2)) & 0x09249249
        return b

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    order = np.argsort(code, kind="stable")
    idx = idx[order]
    v0, v1, v2 = v0[order], v1[order], v2[order]

    # Minimum 256 columns. Pad columns are free: their all-zero BW rows
    # give d.n = 0, rejected by DET_EPS.
    tp_pad = max(256, ((tp + 127) // 128) * 128)
    tr_bw = np.zeros((16, tp_pad), np.float32)  # pad cols: d.n = 0 rejects
    tr_bw[:, :tp] = sl_bw[:, lo:hi][:, idx]

    # Per-128-column-group AABBs over FULL triangle extents (+ valid flag).
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    gp_pad = max(128, ((tp_pad // 128 + 127) // 128) * 128)
    tr_grp = np.zeros((7, gp_pad), np.float32)
    for g in range(tp_pad // 128):
        sl = slice(g * 128, min((g + 1) * 128, tp))
        if sl.start >= tp:
            break
        tr_grp[0:3, g] = tmin[sl].min(axis=0)
        tr_grp[3:6, g] = tmax[sl].max(axis=0)
        tr_grp[6, g] = 1.0
    attr = attr_all[idx]
    colmap = np.zeros(tp_pad, np.int32)
    colmap[:tp] = lo + idx
    modelmap = np.zeros(tp_pad, np.int32)
    modelmap[:tp] = attr_all[idx, 27].astype(np.int32)
    rows = np.zeros((9, tp_pad), np.float32)
    uv0, uv1, uv2 = attr[:, 21:23], attr[:, 23:25], attr[:, 25:27]
    rows[0:2, :tp] = uv0.T
    rows[2:4, :tp] = (uv1 - uv0).T  # f32 sub == the XLA path's runtime sub
    rows[4:6, :tp] = (uv2 - uv0).T
    rows[6, :tp] = attr[:, ATTR_OPACITY_F]
    tids = attr[:, ATTR_OPACITY_T].astype(np.int32)
    used = np.unique(tids[tids >= 0])
    if len(used) > int(os.environ.get("PT_TRWALK_PAGES", "8")):
        return placeholder
    textured = len(used) > 0
    pages = []
    tex8 = np.zeros((8, 128), np.float32)
    if textured:
        # Stack the distinct opacity textures as vertical pages of one
        # plane: Wp = max padded width, page p at rows [ybase, ybase+h).
        planes = []
        ybase = 0
        wp = 128
        for t in (int(t) for t in used):
            w, h = int(widths[t]), int(heights[t])
            off = int(offsets[t])
            plane = atlas_data[off : off + w * h, 0]
            r255 = plane.astype(np.float64) * 255.0
            ru = np.round(r255)
            if (np.abs(r255 - ru).max() > 1e-3
                    or not np.array_equal(plane, lut[ru.astype(np.int32)])):
                return placeholder  # not u8-exact: in-kernel fetch diverges
            planes.append(ru.reshape(h, w))
            pages.append((off, w, h, ybase))
            ybase += h
            wp = max(wp, ((w + 127) // 128) * 128)
        hp = ((ybase + 127) // 128) * 128
        if hp * wp > int(os.environ.get("PT_TRWALK_TEXMAX", str(1 << 21))):
            return placeholder
        tex8 = np.zeros((hp, wp), np.float32)
        for (off, w, h, yb), pl in zip(pages, planes):
            tex8[yb : yb + h, :w] = pl
        rows[7, :tp] = (tids >= 0).astype(np.float32)
        page_of = {int(t): p for p, t in enumerate(used)}
        rows[8, :tp] = np.array(
            [float(page_of[int(t)]) if t >= 0 else 0.0 for t in tids],
            np.float32)
    return (tr_bw, rows, tr_grp, colmap, modelmap,
            tex8, lut_row, tuple(pages), textured, True)


SPH_BLOCK = 128  # spheres per block in the sphere block walk
SPH_BLOCKS_MIN = 512  # dense pass below this sphere count (measured fine)


def _sphere_blocks(centers: np.ndarray, radii: np.ndarray):
    """SAH-blocked sphere tables, built for a sphere block-walk kernel since
    removed (PERF.md Findings; a GPU sphere walk is ROADMAP Reach 3):
    spheres grouped into 128-slot blocks by binned-SAH leaves over their
    AABBs, so a walk can skip the dense O(rays x spheres) pass (the
    reference's scene KD-tree prunes sphere models too, internal/mod.rs:42).

    Returns (sorted_packed [4, nslots], blk [8, SBpad], blkid [1, SBpad],
    smap [nslots] i32 sorted-slot -> original sphere id, use_blocks)."""
    s = centers.shape[0]
    placeholder = (np.zeros((4, 128), np.float32),
                   np.zeros((8, 128), np.float32),
                   np.full((1, 128), -1, np.int32),
                   np.zeros(128, np.int32), False)
    if s <= SPH_BLOCKS_MIN:
        return placeholder
    from path_tracer_tpu.native import build_bvh

    b = build_bvh(centers - radii[:, None], centers + radii[:, None],
                  leaf_size=SPH_BLOCK)
    leaves = np.nonzero(b.prim_count > 0)[0]
    nblk = len(leaves)
    nslots = nblk * SPH_BLOCK
    packed = np.full((4, nslots), 1e30, np.float32)
    packed[3, :] = 0.0  # pad spheres: far degenerate, never hit
    smap = np.zeros(nslots, np.int32)
    blkmin = np.empty((nblk, 3), np.float32)
    blkmax = np.empty((nblk, 3), np.float32)
    for i, ni in enumerate(leaves):
        f, c = int(b.first_prim[ni]), int(b.prim_count[ni])
        ids = b.prim_order[f : f + c]
        sl = slice(i * SPH_BLOCK, i * SPH_BLOCK + c)
        packed[0:3, sl] = centers[ids].T
        packed[3, sl] = radii[ids]
        smap[sl] = ids
        blkmin[i] = (centers[ids] - radii[ids, None]).min(axis=0)
        blkmax[i] = (centers[ids] + radii[ids, None]).max(axis=0)
    sb_pad = max(128, ((nblk + 127) // 128) * 128)
    blk = np.zeros((8, sb_pad), np.float32)
    blk[0:3, :nblk] = blkmin.T
    blk[3:6, :nblk] = blkmax.T
    blkid = np.full((1, sb_pad), -1, np.int32)
    blkid[0, :nblk] = np.arange(nblk)
    return packed, blk, blkid, smap, True


def _pack_spheres(centers: np.ndarray, radii: np.ndarray) -> np.ndarray:
    """[4, S_pad] lane-major sphere table padded with guaranteed misses.

    Big tables pad to a 512 multiple (512-column chunks), small tables to
    128."""
    s = centers.shape[0]
    s_pad = _pad_to(s, 128) if s <= 384 else _pad_to(s, 512)
    out = np.full((4, s_pad), 1e30, np.float32)
    out[3, :] = 0.0
    out[0:3, :s] = centers.T
    out[3, :s] = radii
    return out


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """All scene data as device arrays. Registered as a JAX pytree."""

    # --- triangles, padded to multiple of _TRI_PAD ---
    tri_v0: jax.Array  # [N,3] f32
    tri_e1: jax.Array  # [N,3] f32  (v1 - v0)
    tri_e2: jax.Array  # [N,3] f32  (v2 - v0)
    tri_n0: jax.Array  # [N,3] f32 vertex normals
    tri_n1: jax.Array  # [N,3]
    tri_n2: jax.Array  # [N,3]
    tri_uv0: jax.Array  # [N,2]
    tri_uv1: jax.Array  # [N,2]
    tri_uv2: jax.Array  # [N,2]
    tri_tangent: jax.Array  # [N,3] normalized tangent (NaN if degenerate UVs,
    #                          matching ref hit.rs:121-127)
    tri_model: jax.Array  # [N] int32 model id (0 for padding; det=0 rejects)

    # --- spheres, padded to >= 1 ---
    sph_center: jax.Array  # [S,3] f32
    sph_radius: jax.Array  # [S] f32
    sph_model: jax.Array  # [S] int32

    # --- materials, one row per model ---
    mat_albedo_factor: jax.Array  # [M,3]
    mat_emissive_factor: jax.Array  # [M,3]
    mat_opacity_factor: jax.Array  # [M]
    mat_metalness_factor: jax.Array  # [M]
    mat_roughness_factor: jax.Array  # [M]
    mat_ior: jax.Array  # [M]
    mat_albedo_tex: jax.Array  # [M] int32, -1 = none
    mat_emissive_tex: jax.Array  # [M] int32
    mat_opacity_tex: jax.Array  # [M] int32
    mat_metalness_tex: jax.Array  # [M] int32
    mat_roughness_tex: jax.Array  # [M] int32
    mat_normal_tex: jax.Array  # [M] int32

    # --- texture atlas (all textures, RGB f32 in [0,1], row-major) ---
    tex_data: jax.Array  # [P,3] f32 (P >= 1; row 0 is a dummy texel)
    tex_wide: jax.Array  # [Pw, WIDE_COLS] channel-interleaved texels
    tex_offset: jax.Array  # [T] int32 start row of each texture
    tex_width: jax.Array  # [T] int32
    tex_height: jax.Array  # [T] int32

    # --- lights ---
    point_pos: jax.Array  # [Lp,3]
    point_color: jax.Array  # [Lp,3]
    dir_dir: jax.Array  # [Ld,3]
    dir_color: jax.Array  # [Ld,3]

    # --- camera + background ---
    cam_to_world: jax.Array  # [4,4] f32 row-major math matrix (world-from-camera)
    cam_fov: jax.Array  # [] f32, vertical fov radians
    background: jax.Array  # [3] f32

    # --- BVH over real triangles (C++ binned-SAH build, native/bvh.cpp) ---
    # Packed node rows [N,8] (see ops/bvh_traverse.pack_nodes) and packed
    # triangle rows [M,9] = (v0,e1,e2) in BVH-permuted order, padded by
    # leaf_size degenerate rows so leaf windows never read out of bounds.
    # Triangle SoA arrays above are stored in the SAME permuted order, so a
    # BVH prim id indexes them directly.
    bvh_nodes: jax.Array  # [N,8] f32
    # Same node metadata as int32 rows [N,2] = (skip, first*256|count).
    bvh_nodes_i: jax.Array  # [N,2] i32
    # Standalone tree over ONLY the possibly-transparent triangles (prim ids
    # global), for transparent-subset walks; bvh_nodes is the [opaque tree |
    # transparent tree] skip-pointer forest of which [0, bvh_n_nodes_opaque)
    # is the opaque-only walk (see opaque_view/transparent_view).
    bvh_nodes_tr: jax.Array  # [N2,8] f32
    bvh_tris: jax.Array  # [M,9] f32
    # Component-major triangle table [9, n_pad] = rows (v0,e1,e2) xyz (read
    # by the dense transparent-column walk).
    tri_packed_t: jax.Array  # [9, n_pad] f32
    # --- Superleaf BVH (lane-major tables) -------------------------------
    # A SECOND, shallow BVH whose leaves are 512-triangle "superleaf" blocks,
    # built for packet kernels since removed (PERF.md Findings). The packed
    # slot order (sl_map / sl_inv / sl_attr) and the block tables that the
    # opacity-partition views slice are still read; the rest is data until
    # the layout clean-up (ROADMAP Design 2).
    # SIX direction-ordered DFS layouts of the superleaf tree (axis*2+neg):
    # children near-first along the dominant ray direction, so best-t
    # pruning fires early (front-to-back stackless traversal).
    sl_nodes6: jax.Array  # [6, 8, Nsl] f32 bounds (mn.xyz, mx.xyz, 2 pad)
    sl_meta6: jax.Array  # [6, 2, Nsl] i32 (skip, block_id+1; 0 = internal)
    # Rows 0-8 are (v0,e1,e2) xyz; rows 9-15 are zero padding.
    sl_tris_t: jax.Array  # [16, n_blocks*512] f32, block-aligned windows
    # Baldwin-Weber rows for the FLAT kernels' dense visits: t from a plane
    # test (n, c = v0.n), then u/v as affine maps of the hit point
    # (Au.h + au, Av.h + av). ~20% fewer ops per (ray, tri) than
    # recomputing the Moller-Trumbore cross products, at 12 rows vs 9
    # (semantics identical: det = -d.n, same DET_EPS/T_MIN/backface tests).
    sl_bw_t: jax.Array  # [16, n_blocks*512] f32 (n.xyz, c, Au.xyz, au, Av.xyz, av, 4 pad rows)
    sl_map: jax.Array  # [n_blocks*512] i32 packed->global prim id (pad: 0)
    # FLAT per-block tables for the flat-visit kernel: with a few hundred
    # superleaf blocks, slab-testing EVERY block bound against the whole ray
    # tile is one [RT,B] vector op — cheaper than walking a node tree
    # serially. A SINGLE layout suffices: the kernel visits blocks by the
    # tile's minimum slab-entry tn (true per-tile front-to-back), so column
    # order is irrelevant; pad columns are marked by block id -1.
    sl_blkflat: jax.Array  # [8, Bpad] f32 (mn.xyz, mx.xyz, 2 pad)
    sl_blkid: jax.Array  # [1, Bpad] i32 block id per column (-1 = pad)
    # SUPERBLOCK bounds for the two-level flat walk (big scenes): column j
    # is the AABB union of block columns [128j, 128j+128). The inner level
    # reads 128-aligned block-column windows, so no explicit membership
    # table is needed.
    sl_sbflat: jax.Array  # [8, SBpad] f32 (mn.xyz, mx.xyz, 2 pad)
    sl_sbid: jax.Array  # [1, SBpad] i32 superblock id (-1 = pad)
    # PACKED-ORDER wide shading-attribute table, one row per superleaf slot.
    # A gather's per-lane cost barely depends on row width, so the ~12
    # narrow per-triangle gathers shading used to do (sl_map, uv0/1/2,
    # n0/1/2, tangent, e1/e2, model) collapse into ONE gather of this table
    # by the packed hit id (sl_inv[prim]). Columns: v0[0:3] e1[3:6] e2[6:9] n0[9:12]
    # n1[12:15] n2[15:18] tangent[18:21] uv0[21:23] uv1[23:25] uv2[25:27]
    # model[27] global_prim[28] (both exact as f32; ids < 2^24), then baked
    # material factors/texture-ids at the ATTR_* columns (module constants).
    # Rows [sph_row_base:] are per-sphere rows (material columns only).
    sl_attr: jax.Array  # [n_blocks*512 + n_sph, ATTR_W] f32
    # Inverse of sl_map: global prim id -> packed superleaf slot, for hit
    # paths that report global ids (brute/jnp tree walk). BVH is a disjoint
    # partition, so every real triangle has exactly one slot; pad ids map
    # to slot 0 (their rows are only read behind an is-triangle mask).
    sl_inv: jax.Array  # [n_pad] i32
    # Lane-major sphere table [4, S_pad] = (cx, cy, cz, r), padded to a
    # 128-lane multiple with guaranteed-miss spheres.
    sph_packed_t: jax.Array  # [4, S_pad] f32
    # Sphere BLOCK-walk tables (sphere-heavy scenes; _sphere_blocks):
    # SAH-blocked sorted sphere table, per-block AABB columns, and the
    # sorted-slot -> original-id map. Placeholders when sph_use_blocks
    # is False (dense pass).
    sph_sorted_t: jax.Array  # [4, nblk*128] f32
    sph_blk: jax.Array  # [8, SBpad] f32 (mn.xyz, mx.xyz, 2 pad)
    sph_blkid: jax.Array  # [1, SBpad] i32 (-1 = pad)
    sph_smap: jax.Array  # [nblk*128] i32
    # [32,6] transparent-cluster prefilter AABBs (mn.xyz, mx.xyz); see the
    # build comment — pads are degenerate far points.
    tr_prefilter: jax.Array
    # --- Transparent-walk tables (built for fused walk kernels since
    # removed; data only now, see _build_tr_walk_tables) ------------------
    # Compact tables of ONLY the transparent partition. Placeholder minima
    # when tr_kernel_ok is False.
    tr_bw: jax.Array  # [16, Tp] transparent slice of sl_bw_t
    # Rows: uv0.xy, (uv1-uv0).xy, (uv2-uv0).xy, opacity factor, has_tex,
    # texture-page index (0 for factor-only columns).
    tr_rows: jax.Array  # [9, Tp] f32
    tr_grp: jax.Array  # [7, GP] Morton group AABBs + valid flag
    # Compact column -> GLOBAL packed slot id (columns hold only REAL
    # transparent triangles; block pad slots are dropped at build).
    tr_colmap: jax.Array  # [Tp] i32
    # Compact column -> model id, for LIVE opacity-factor rows in training
    # mode (a train step may dataclasses.replace mat_opacity_factor; the
    # walk rebuilt row 6 from the live table at dispatch).
    tr_model: jax.Array  # [Tp] i32
    # The distinct opacity textures' u8 texel VALUES (0..255, exact in
    # bf16), stacked as vertical PAGES
    # (tr_pages gives each page's rows); padded to 128 multiples with zeros.
    tr_tex8: jax.Array  # [Hp, Wp] bf16
    # Exact dequant LUT: tr_lut[0, v] == np.float32(v / 255.0), the
    # correctly-rounded host division that built tex_data.
    tr_lut: jax.Array  # [1, 256] f32

    # --- static (non-traced) scene facts; part of the jit key -------------
    # True when every material is fully opaque (opacity factor >= 1, no
    # opacity texture). Lets the integrator collapse the stochastic alpha
    # walk (ref mod.rs:188-205) and the shadow occluder walk
    # (ref mod.rs:283-331) to a single closest-hit cast each — the extra
    # walk steps exist only to reproduce alpha semantics.
    all_opaque: bool = dataclasses.field(
        metadata=dict(static=True), default=False
    )
    # True when no material has any texture — material sampling is then a
    # pure factor table lookup and the atlas gather can be skipped.
    no_textures: bool = dataclasses.field(
        metadata=dict(static=True), default=False
    )
    # True when no material emits (all emissive factors zero, no emissive
    # textures). Then eval_direct for a lane with n.l <= 0 is EXACTLY zero
    # (diffuse and spec both carry max(n.l, 0); the emissive-in-eval_direct
    # quirk term is zero too), so the integrator can skip that lane's shadow
    # cast entirely — about half the lanes per light on closed geometry.
    no_emissive: bool = dataclasses.field(
        metadata=dict(static=True), default=False
    )
    # Upper bound on the number of POSSIBLY-TRANSPARENT hits any single ray
    # line can produce: triangles of models whose material can be non-opaque
    # (opacity factor < 1 or an opacity texture) count once, spheres twice
    # (near + far root surface on a re-cast). The integrator sizes the alpha
    # and shadow walk bounds to this + 1 by default, which makes the bounded
    # re-cast walks EXACTLY equivalent to the reference's unbounded
    # sorted-hit iteration (ref mod.rs:188-205,283-331): a walk terminates
    # the step it visits an opaque hit or finds nothing, so it can never
    # take more than num_transparent_hits + 1 productive steps.
    num_transparent_hits: int = dataclasses.field(
        metadata=dict(static=True), default=0
    )
    # Real (unpadded) primitive counts; a zero lets the intersector skip the
    # whole primitive class statically (tri arrays are padded to >= _TRI_PAD
    # and sphere arrays to >= 1 even when the scene has none).
    num_real_triangles: int = dataclasses.field(
        metadata=dict(static=True), default=-1
    )
    # First sphere row in sl_attr (= number of triangle-slot rows). Sphere
    # hit records carry packed = sph_row_base + sphere_index so the wide
    # shading gather covers both primitive kinds.
    sph_row_base: int = dataclasses.field(
        metadata=dict(static=True), default=0
    )
    num_real_spheres: int = dataclasses.field(
        metadata=dict(static=True), default=-1
    )
    # Static BVH facts: traversal leaf window size, and whether the
    # integrator should use BVH traversal instead of the brute-force block
    # scan (small scenes stay brute-force; see use_bvh below).
    bvh_leaf_size: int = dataclasses.field(metadata=dict(static=True), default=4)
    # Real (unpadded) node count — the traversal termination sentinel (node
    # arrays are padded to a multiple of 128 for aligned window reads).
    bvh_n_nodes: int = dataclasses.field(metadata=dict(static=True), default=1)
    # Superleaf-BVH statics: real node count and the block size.
    sl_n_nodes: int = dataclasses.field(metadata=dict(static=True), default=1)
    sl_block: int = dataclasses.field(metadata=dict(static=True), default=512)
    sl_n_blocks: int = dataclasses.field(metadata=dict(static=True), default=0)
    use_bvh: bool = dataclasses.field(metadata=dict(static=True), default=False)
    # --- Opacity-partition statics (see the partition comment in
    # build_device_scene): triangles are stored [opaque.. | transparent..],
    # superleaf blocks/columns and the leaf-4 node forest likewise. ---
    n_tris_opaque: int = dataclasses.field(metadata=dict(static=True), default=0)
    sl_n_blocks_opaque: int = dataclasses.field(
        metadata=dict(static=True), default=0)
    # 128-aligned column offset where transparent block columns start in
    # sl_blkflat/sl_blkid (= padded opaque column count).
    sl_cols_opaque: int = dataclasses.field(
        metadata=dict(static=True), default=0)
    bvh_n_nodes_opaque: int = dataclasses.field(
        metadata=dict(static=True), default=0)
    bvh_n_nodes_tr: int = dataclasses.field(
        metadata=dict(static=True), default=1)
    # True when every SPHERE is opaque (the partitioned fast path folds all
    # spheres into the opaque cast; a transparent sphere forces the generic
    # walk).
    sph_all_opaque: bool = dataclasses.field(
        metadata=dict(static=True), default=True)
    # True when the ATTR_*_G atlas-geometry columns are valid (atlas small
    # enough for exact f32 offsets) — the rows-based texel fetch then skips
    # the tex_offset/width/height table gathers.
    attr_tex_baked: bool = dataclasses.field(
        metadata=dict(static=True), default=False)
    # Per-channel "any model has this texture" flags, ordered (albedo,
    # emissive, opacity, metalness, roughness, normal). A False statically
    # removes that channel's atlas gather from sampling.
    has_tex: tuple = dataclasses.field(
        metadata=dict(static=True), default=(False,) * 6)
    # Per-channel "every texture on this channel rides tex_wide" flags,
    # same order as has_tex. A True statically replaces that channel's
    # individual atlas gather with a column slice of the ONE wide gather.
    wide_covered: tuple = dataclasses.field(
        metadata=dict(static=True), default=(False,) * 6)
    # Transparent-walk table statics (see _build_tr_walk_tables): tables
    # valid, the texture-page layout, and whether any transparent model
    # samples an opacity texture (False = factor-only walk, fetch skipped).
    tr_kernel_ok: bool = dataclasses.field(
        metadata=dict(static=True), default=False)
    # One (atlas_offset, w, h, ybase) tuple per distinct opacity texture —
    # pages of the stacked tr_tex8 plane (see _build_tr_walk_tables).
    tr_pages: tuple = dataclasses.field(metadata=dict(static=True),
                                        default=())
    tr_textured: bool = dataclasses.field(
        metadata=dict(static=True), default=False)
    # True when sphere casts route through the block-walk kernels
    # (sphere-heavy scenes; see _sphere_blocks).
    sph_use_blocks: bool = dataclasses.field(
        metadata=dict(static=True), default=False)

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def num_point_lights(self) -> int:
        return self.point_pos.shape[0]

    @property
    def num_dir_lights(self) -> int:
        return self.dir_dir.shape[0]


class _AtlasBuilder:
    """Packs textures into one flat RGB array, deduplicating by path+kind.

    Plays the role of the reference's TextureBank (ref: texture_bank.rs:6-52):
    the same file loaded as RGB and as gray are distinct entries, exactly like
    the reference's separate rgb/gray maps.
    """

    def __init__(self, root: Path):
        self.root = Path(root)
        self.chunks = [np.zeros((1, 3), np.float32)]  # dummy texel at offset 0
        self.offsets = [0]
        self.widths = [1]
        self.heights = [1]
        self.next_offset = 1
        self.cache = {}

    def add(self, rel_path: Optional[str], kind: str) -> int:
        """Returns texture id, or -1 if rel_path is None. kind: 'rgb'|'gray'."""
        if rel_path is None:
            return -1
        key = (kind, rel_path)
        if key in self.cache:
            return self.cache[key]
        path = self.root / rel_path
        if kind == "rgb":
            img = load_texture_rgb(path)  # [H,W,3] f32 in [0,1]
        else:
            gray = load_texture_gray(path)  # [H,W] f32 in [0,1]
            img = np.repeat(gray[:, :, None], 3, axis=2)
        h, w = img.shape[:2]
        tex_id = len(self.offsets)
        self.chunks.append(img.reshape(h * w, 3).astype(np.float32))
        self.offsets.append(self.next_offset)
        self.widths.append(w)
        self.heights.append(h)
        self.next_offset += h * w
        self.cache[key] = tex_id
        return tex_id


def build_device_scene(scene: isf.Scene, root,
                       use_bvh: Optional[bool] = None,
                       sl_block: int = 512) -> DeviceScene:
    """Flatten an ISF scene into device SoA arrays.

    Mirrors Scene::load (ref: src/scene/internal/mod.rs:35-51) minus the
    KD-tree builds — spatial acceleration is a separate, optional BVH pass.
    """
    root = Path(root)
    atlas = _AtlasBuilder(root)

    tri_rows = {k: [] for k in ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2")}
    tri_model = []
    tri_transparent = []  # per-tri: model material can be non-opaque
    sph_center, sph_radius, sph_model = [], [], []
    sph_all_opaque = True
    mats = {
        "albedo_f": [], "emissive_f": [], "opacity_f": [], "metal_f": [],
        "rough_f": [], "ior": [], "albedo_t": [], "emissive_t": [],
        "opacity_t": [], "metal_t": [], "rough_t": [], "normal_t": [],
    }

    def _certainly_opaque_tris(model, m) -> list:
        """Per-triangle refinement of a transparent-material mesh: a
        triangle whose opacity-texture footprint GUARANTEES op >= 1 behaves
        exactly like opaque geometry (the alpha walk's accept test
        short-circuits at op >= 1 without drawing a random number,
        ref mod.rs:201, and shadow transmittance hits exact 0) — so it can
        live in the OPAQUE partition, shrinking the transparent walk set to
        the texels that actually need stochastic handling (alpha-cutout
        rims). Conservative: min texel over the wrapped UV-bbox (superset
        of the triangle's footprint), expanded one texel each way."""
        if m.opacity.factor < 1.0 or m.opacity.texture is None:
            return [False] * len(model.triangles)
        gray = load_texture_gray(root / m.opacity.texture)  # [H,W] in [0,1]
        th, tw = gray.shape
        out = []
        for tri in model.triangles:
            us = [v.tex_coords[0] for v in tri]
            vs = [v.tex_coords[1] for v in tri]
            x0 = int(np.floor(min(us) * tw)) - 1
            x1 = int(np.floor(max(us) * tw)) + 1
            y0 = int(np.floor(min(vs) * th)) - 1
            y1 = int(np.floor(max(vs) * th)) + 1
            xs = (np.arange(x0, min(x1, x0 + tw) + 1)) % tw
            ys = (np.arange(y0, min(y1, y0 + th) + 1)) % th
            mn = float(gray[np.ix_(ys, xs)].min())
            out.append(mn * m.opacity.factor >= 1.0)
        return out

    n_transparent_hits = 0
    for model_id, model in enumerate(scene.models):
        m = model.material
        transparent = m.opacity.factor < 1.0 or m.opacity.texture is not None
        if transparent and not isinstance(model, isf.Mesh):
            n_transparent_hits += 2  # near + far sphere root on a re-cast
            sph_all_opaque = False
        mats["albedo_f"].append(m.albedo.factor)
        mats["emissive_f"].append(m.emissive.factor)
        mats["opacity_f"].append(m.opacity.factor)
        mats["metal_f"].append(m.metalness.factor)
        mats["rough_f"].append(m.roughness.factor)
        mats["ior"].append(m.ior)
        mats["albedo_t"].append(atlas.add(m.albedo.texture, "rgb"))
        mats["emissive_t"].append(atlas.add(m.emissive.texture, "rgb"))
        mats["opacity_t"].append(atlas.add(m.opacity.texture, "gray"))
        mats["metal_t"].append(atlas.add(m.metalness.texture, "gray"))
        mats["rough_t"].append(atlas.add(m.roughness.texture, "gray"))
        mats["normal_t"].append(atlas.add(m.normal_texture, "rgb"))

        if isinstance(model, isf.Mesh):
            if transparent:
                certain = _certainly_opaque_tris(model, m)
            for ti, (v0, v1, v2) in enumerate(model.triangles):
                tri_rows["v0"].append(v0.position)
                tri_rows["v1"].append(v1.position)
                tri_rows["v2"].append(v2.position)
                tri_rows["n0"].append(v0.normal)
                tri_rows["n1"].append(v1.normal)
                tri_rows["n2"].append(v2.normal)
                tri_rows["uv0"].append(v0.tex_coords)
                tri_rows["uv1"].append(v1.tex_coords)
                tri_rows["uv2"].append(v2.tex_coords)
                tri_model.append(model_id)
                is_tr = transparent and not certain[ti]
                tri_transparent.append(is_tr)
                n_transparent_hits += int(is_tr)
        else:
            sph_center.append(model.center)
            sph_radius.append(model.radius)
            sph_model.append(model_id)

    n_tris = len(tri_model)
    # Wide-texel table (one gather per material sample; see _build_wide_tex).
    _wide_atlas_np = (np.concatenate(atlas.chunks, axis=0)
                      if len(atlas.offsets) > 1
                      else np.zeros((1, 3), np.float32))
    (tex_wide_np, _woff, _ww, _wh, wide_covered) = _build_wide_tex(
        mats, _wide_atlas_np, atlas.offsets, atlas.widths, atlas.heights)
    wide_mats = (_woff, _ww, _wh)
    # OPACITY PARTITION: reorder triangles so every opaque-material triangle
    # precedes every possibly-transparent one (stable within each class).
    # The acceleration structures are then built PER PARTITION and
    # concatenated, so the integrator's alpha/shadow walks can cast against
    # exactly the subset they need: one opaque terminator/any-hit cast (the
    # bulk of the scene) + a bounded walk over only the transparent prims.
    # The reference gets the same effect implicitly from its sorted all-hits
    # iteration (ref mod.rs:188-205, 283-331); here the partition is what
    # keeps textured-alpha scenes off the O(walk_steps x full-scene-cast)
    # path. Statics: n_tris_opaque, sl_n_blocks_opaque, bvh_n_nodes_opaque.
    tri_transparent = np.asarray(tri_transparent, np.bool_) \
        if n_tris else np.zeros(0, np.bool_)
    n_op_tris = int((~tri_transparent).sum())
    if n_tris and 0 < n_op_tris < n_tris:
        order = np.concatenate([np.nonzero(~tri_transparent)[0],
                                np.nonzero(tri_transparent)[0]])
        for k in tri_rows:
            rows = tri_rows[k]
            tri_rows[k] = [rows[i] for i in order]
        tri_model = [tri_model[i] for i in order]
    n_pad = _pad_to(n_tris, _TRI_PAD)

    def _pad3(rows, dim):
        arr = np.zeros((n_pad, dim), np.float32)
        if rows:
            arr[:n_tris] = np.asarray(rows, np.float32)
        return arr

    v0 = _pad3(tri_rows["v0"], 3)
    v1 = _pad3(tri_rows["v1"], 3)
    v2 = _pad3(tri_rows["v2"], 3)
    e1 = v1 - v0
    e2 = v2 - v0

    # Per-triangle tangent from UV deltas (ref hit.rs:116-127). delta_uv1/2
    # equal uv1-uv0 / uv2-uv0; f = 1/(du1.x*du2.y - du2.x*du1.y).
    uv0 = _pad3(tri_rows["uv0"], 2)
    uv1 = _pad3(tri_rows["uv1"], 2)
    uv2 = _pad3(tri_rows["uv2"], 2)
    du1 = uv1 - uv0
    du2 = uv2 - uv0
    with np.errstate(divide="ignore", invalid="ignore"):
        f = 1.0 / (du1[:, 0] * du2[:, 1] - du2[:, 0] * du1[:, 1])
        tangent = f[:, None] * (du2[:, 1:2] * e1 - du1[:, 1:2] * e2)
        norm = np.sqrt((tangent * tangent).sum(-1, keepdims=True))
        tangent = tangent / norm  # NaN for degenerate UVs, matching reference
    tangent = np.where(np.isfinite(tangent), tangent, 0.0).astype(np.float32)

    tri_model_arr = np.zeros(n_pad, np.int32)
    if n_tris:
        tri_model_arr[:n_tris] = np.asarray(tri_model, np.int32)

    n0 = _pad3(tri_rows["n0"], 3)
    n1 = _pad3(tri_rows["n1"], 3)
    n2 = _pad3(tri_rows["n2"], 3)

    # --- BVH over the real triangles (C++ binned-SAH, native/bvh.cpp) -----
    # Built PER OPACITY PARTITION and concatenated as a skip-pointer FOREST:
    # tree 1 (opaque) occupies nodes [0, N1) and its exit skip (N1) falls
    # through into tree 2 (transparent) at [N1, N1+N2). A full-scene walk
    # uses the whole forest unchanged; an opaque-only walk is the SAME array
    # with the termination sentinel bvh_n_nodes set to N1; the standalone
    # transparent tree (bvh_nodes_tr, prim ids global) serves
    # transparent-only walks. See opaque_view()/transparent_view().
    from path_tracer_tpu.ops.bvh_traverse import pack_nodes

    def _miss_nodes():
        return pack_nodes(
            np.full((1, 3), np.inf, np.float32),
            np.full((1, 3), -np.inf, np.float32),
            np.zeros(1, np.int32), np.zeros(1, np.int32),
            np.ones(1, np.int32),
        )

    leaf_size = 4
    if n_tris:
        from path_tracer_tpu.native import build_bvh

        p0 = v0[:n_tris]
        p1 = p0 + e1[:n_tris]
        p2 = p0 + e2[:n_tris]
        tri_min = np.minimum(np.minimum(p0, p1), p2)
        tri_max = np.maximum(np.maximum(p0, p1), p2)

        def _pack(b, prim_off, skip_off):
            return pack_nodes(b.node_min, b.node_max,
                              b.first_prim + prim_off, b.prim_count,
                              b.skip + skip_off)

        if 0 < n_op_tris < n_tris:
            b_op = build_bvh(tri_min[:n_op_tris], tri_max[:n_op_tris],
                             leaf_size=leaf_size)
            b_tr = build_bvh(tri_min[n_op_tris:], tri_max[n_op_tris:],
                             leaf_size=leaf_size)
            perm = np.concatenate([b_op.prim_order,
                                   n_op_tris + b_tr.prim_order])
            n_nodes_op = int(b_op.skip.shape[0])
            bvh_nodes = np.concatenate(
                [_pack(b_op, 0, 0), _pack(b_tr, n_op_tris, n_nodes_op)],
                axis=0)
            bvh_nodes_tr = _pack(b_tr, n_op_tris, 0)
            bvh_n_nodes_opaque = n_nodes_op
            bvh_n_nodes_tr = int(b_tr.skip.shape[0])
        else:
            bvh = build_bvh(tri_min, tri_max, leaf_size=leaf_size)
            perm = bvh.prim_order
            bvh_nodes = _pack(bvh, 0, 0)
            if n_op_tris == n_tris:  # all opaque
                bvh_nodes_tr = _miss_nodes()
                bvh_n_nodes_opaque = int(bvh.skip.shape[0])
                bvh_n_nodes_tr = 1
            else:  # all transparent
                bvh_nodes_tr = bvh_nodes.copy()
                bvh_n_nodes_opaque = 0
                bvh_n_nodes_tr = int(bvh.skip.shape[0])
        # Store ALL triangle SoA arrays in BVH-permuted order so prim ids
        # index them directly (padding rows stay at the tail; the partition
        # split point n_op_tris is preserved — each partition's permutation
        # stays inside its own range).
        for arr in (v0, e1, e2, uv0, uv1, uv2, tangent, n0, n1, n2):
            arr[:n_tris] = arr[:n_tris][perm]
        tri_model_arr[:n_tris] = tri_model_arr[:n_tris][perm]
    else:
        # Single always-miss node so shapes stay valid.
        bvh_nodes = _miss_nodes()
        bvh_nodes_tr = _miss_nodes()
        bvh_n_nodes_opaque = 1
        bvh_n_nodes_tr = 1
    # Packed (v0,e1,e2) rows. Padding: the packet kernel reads 128-aligned
    # 256-wide lane windows around a leaf's first prim, so pad to a multiple
    # of 128 plus a 256 margin (degenerate rows: det == 0 rejects).
    m_pad = ((n_pad + 127) // 128) * 128 + 256
    bvh_tris = np.zeros((m_pad, 9), np.float32)
    bvh_tris[:n_pad, 0:3] = v0
    bvh_tris[:n_pad, 3:6] = e1
    bvh_tris[:n_pad, 6:9] = e2
    # Node tables padded to a multiple of 128 for the same aligned windows
    # (pad rows are never selected: traversal guards i < n_nodes).
    nn = bvh_nodes.shape[0]
    nn_pad = ((nn + 127) // 128) * 128
    if nn_pad != nn:
        pad_rows = np.zeros((nn_pad - nn, 8), np.float32)
        bvh_nodes = np.concatenate([bvh_nodes, pad_rows], axis=0)

    # --- Superleaf BVH (shallow tree over 512-tri blocks); built over the
    # leaf4-PERMUTED arrays so block prim ids are directly the global
    # (permuted) triangle ids.
    SL_BLOCK = sl_block
    assert SL_BLOCK % 128 == 0, "superleaf blocks must be 128-lane aligned"
    if n_tris:
        from path_tracer_tpu.native import build_bvh as _build_bvh
        from path_tracer_tpu.scene.bvh_layouts import (
            build_directional_layouts_forest,
        )

        q0 = v0[:n_tris]
        q1 = q0 + e1[:n_tris]
        q2 = q0 + e2[:n_tris]
        qmin = np.minimum(np.minimum(q0, q1), q2)
        qmax = np.maximum(np.maximum(q0, q1), q2)
        # One superleaf BVH per opacity partition (see the leaf-4 forest
        # comment above); blocks are numbered globally [opaque..,
        # transparent..] so block ids index the SHARED sl_tris_t / sl_bw_t /
        # sl_attr tables from any column subset.
        if 0 < n_op_tris < n_tris:
            ranges = [(0, n_op_tris), (n_op_tris, n_tris)]
        else:
            ranges = [(0, n_tris)]
        part_sls = [_build_bvh(qmin[a:b], qmax[a:b], leaf_size=SL_BLOCK)
                    for a, b in ranges]
        part_nblk = [int((s.prim_count > 0).sum()) for s in part_sls]
        n_blocks = sum(part_nblk)
        assert n_tris < (1 << 24), "f32 prim ids in sl_attr need n < 2^24"
        sl_tris = np.zeros((n_blocks * SL_BLOCK, 9), np.float32)
        sl_map = np.zeros(n_blocks * SL_BLOCK, np.int32)
        sl_attr = np.zeros((n_blocks * SL_BLOCK, ATTR_W), np.float32)
        sl_inv = np.zeros(n_pad, np.int32)
        blk_min_all = np.zeros((n_blocks, 3), np.float32)
        blk_max_all = np.zeros((n_blocks, 3), np.float32)
        trees = []
        bcur = 0
        for (a, _b), slp in zip(ranges, part_sls):
            leaf_nodes = np.nonzero(slp.prim_count > 0)[0]
            meta_leaf = np.zeros(slp.skip.shape[0], np.int32)
            for k, ni in enumerate(leaf_nodes):
                bg = bcur + k  # global block id
                f, c = int(slp.first_prim[ni]), int(slp.prim_count[ni])
                ids = a + slp.prim_order[f : f + c]
                base = bg * SL_BLOCK
                sl_tris[base : base + c, 0:3] = v0[ids]
                sl_tris[base : base + c, 3:6] = e1[ids]
                sl_tris[base : base + c, 6:9] = e2[ids]
                sl_map[base : base + c] = ids
                sl_attr[base : base + c, 0:3] = v0[ids]
                sl_attr[base : base + c, 3:6] = e1[ids]
                sl_attr[base : base + c, 6:9] = e2[ids]
                sl_attr[base : base + c, 9:12] = n0[ids]
                sl_attr[base : base + c, 12:15] = n1[ids]
                sl_attr[base : base + c, 15:18] = n2[ids]
                sl_attr[base : base + c, 18:21] = tangent[ids]
                sl_attr[base : base + c, 21:23] = uv0[ids]
                sl_attr[base : base + c, 23:25] = uv1[ids]
                sl_attr[base : base + c, 25:27] = uv2[ids]
                sl_attr[base : base + c, 27] = tri_model_arr[ids]
                sl_attr[base : base + c, 28] = ids
                sl_inv[ids] = np.arange(base, base + c, dtype=np.int32)
                meta_leaf[ni] = bg + 1
            blk_min_all[bcur : bcur + len(leaf_nodes)] = slp.node_min[leaf_nodes]
            blk_max_all[bcur : bcur + len(leaf_nodes)] = slp.node_max[leaf_nodes]
            trees.append((slp.node_min, slp.node_max, slp.prim_count,
                          slp.skip, meta_leaf))
            bcur += len(leaf_nodes)
        # Baked per-row material columns (ATTR_* layout below): factors and
        # texture ids copied from the row's model so shading needs NO separate
        # model-indexed gathers (used only on the non-differentiable render
        # path — training reads the live factor arrays so gradients flow).
        _bake_material_rows(sl_attr, sl_attr[:, 27].astype(np.int32), mats,
                            wide=wide_mats,
                            atlas=(atlas.offsets, atlas.widths,
                                   atlas.heights))
        nsl = sum(t[3].shape[0] for t in trees)
        sl_nodes6, sl_meta6 = build_directional_layouts_forest(trees)
        # Partition block counts and 128-aligned column offsets.
        if len(ranges) == 2:
            nblk_op, nblk_tr = part_nblk
        elif n_op_tris == n_tris:
            nblk_op, nblk_tr = n_blocks, 0
        else:
            nblk_op, nblk_tr = 0, n_blocks
        cols_op = ((nblk_op + 127) // 128) * 128 if nblk_op else 0
        cols_tr = ((nblk_tr + 127) // 128) * 128 if nblk_tr else 0
        # Flat per-block tables for the flat-visit kernel: block bounds are
        # the superleaf trees' leaf bounds. Opaque blocks fill columns
        # [0, cols_op) (ids 0..nblk_op-1), transparent blocks fill
        # [cols_op, cols_op+cols_tr) (ids nblk_op..n_blocks-1); interior
        # pad columns carry block id -1, masked in the kernels (NOTE:
        # inverted-inf bounds do NOT fail a slab test — min/max reorders the
        # infinities into an always-pass interval — hence id masking).
        b_pad = max(128, cols_op + cols_tr)
        sl_blkflat = np.zeros((8, b_pad), np.float32)
        sl_blkid = np.full((1, b_pad), -1, np.int32)
        sl_blkflat[0:3, :nblk_op] = blk_min_all[:nblk_op].T
        sl_blkflat[3:6, :nblk_op] = blk_max_all[:nblk_op].T
        sl_blkid[0, :nblk_op] = np.arange(nblk_op)
        if nblk_tr:
            sl_blkflat[0:3, cols_op : cols_op + nblk_tr] = blk_min_all[nblk_op:].T
            sl_blkflat[3:6, cols_op : cols_op + nblk_tr] = blk_max_all[nblk_op:].T
            sl_blkid[0, cols_op : cols_op + nblk_tr] = np.arange(nblk_op, n_blocks)
        # Superblock unions over 128-column groups (pad columns are the
        # min/max identities so they never widen a union; the 128-aligned
        # partition offsets keep every group inside ONE partition, which is
        # what lets the views slice sb columns too).
        nsb = b_pad // 128
        col_valid = (sl_blkid[0] >= 0)
        gm = np.where(col_valid[:, None], 0.0, np.inf).astype(np.float32)
        gx = np.where(col_valid[:, None], 0.0, -np.inf).astype(np.float32)
        gm = gm + sl_blkflat[0:3].T
        gx = gx + sl_blkflat[3:6].T
        sb_pad = ((nsb + 127) // 128) * 128
        sl_sbflat = np.zeros((8, sb_pad), np.float32)
        sl_sbid = np.full((1, sb_pad), -1, np.int32)
        valid = col_valid.reshape(nsb, 128).any(axis=1)
        sb_min = gm.reshape(nsb, 128, 3).min(axis=1)
        sb_max = gx.reshape(nsb, 128, 3).max(axis=1)
        sl_sbflat[0:3, :nsb] = np.where(valid[None, :], sb_min.T, 0.0)
        sl_sbflat[3:6, :nsb] = np.where(valid[None, :], sb_max.T, 0.0)
        sl_sbid[0, :nsb] = np.where(valid, np.arange(nsb), -1)
        # Transparent-cluster PREFILTER boxes: ~32 tight AABBs over the
        # transparent triangles. The partitioned walks slab-test every
        # lane's segment against these in pure fused XLA (no gather, no
        # kernel launch) and skip the walk for lanes that cannot touch
        # transparent geometry, which empties whole chunks of the walk.
        # Padding boxes are degenerate points at
        # 1e30 (their slab interval misses every real segment).
        n_tr_tris = n_tris - n_op_tris
        tr_prefilter = np.full((32, 6), 1e30, np.float32)
        if n_tr_tris:
            tb = _build_bvh(qmin[n_op_tris:], qmax[n_op_tris:],
                            leaf_size=max(4, (n_tr_tris + 31) // 32))
            leaf = np.nonzero(tb.prim_count > 0)[0]
            lmin, lmax = tb.node_min[leaf], tb.node_max[leaf]
            if len(leaf) > 32:
                # SAH can emit more leaves than n/leaf_size; coverage must
                # stay COMPLETE — union the overflow into slot 31.
                lmin = np.concatenate(
                    [lmin[:31], lmin[31:].min(axis=0, keepdims=True)])
                lmax = np.concatenate(
                    [lmax[:31], lmax[31:].max(axis=0, keepdims=True)])
            tr_prefilter[: len(lmin), 0:3] = lmin
            tr_prefilter[: len(lmin), 3:6] = lmax
    else:
        nblk_op = nblk_tr = 0
        tr_prefilter = np.full((32, 6), 1e30, np.float32)
        cols_op = cols_tr = 0
        n_blocks = 0
        nsl = 1
        sl_nodes6 = np.zeros((6, 8, 128), np.float32)
        sl_nodes6[:, 0:3, 0] = np.inf
        sl_nodes6[:, 3:6, 0] = -np.inf
        sl_meta6 = np.zeros((6, 2, 128), np.int32)
        sl_meta6[:, 0, 0] = 1
        sl_tris = np.zeros((SL_BLOCK, 9), np.float32)
        sl_map = np.zeros(SL_BLOCK, np.int32)
        sl_attr = np.zeros((SL_BLOCK, ATTR_W), np.float32)
        sl_inv = np.zeros(n_pad, np.int32)
        sl_blkflat = np.zeros((8, 128), np.float32)
        sl_blkid = np.full((1, 128), -1, np.int32)
        sl_sbflat = np.zeros((8, 128), np.float32)
        sl_sbid = np.full((1, 128), -1, np.int32)

    # Spheres padded to >= 1 with a guaranteed-miss entry (center at 1e30 so
    # the quadratic discriminant is hugely negative for any practical ray).
    n_sph = max(1, len(sph_radius))
    centers = np.full((n_sph, 3), 1e30, np.float32)
    radii = np.zeros(n_sph, np.float32)
    sph_model_arr = np.zeros(n_sph, np.int32)
    if sph_radius:
        centers[: len(sph_radius)] = np.asarray(sph_center, np.float32)
        radii[: len(sph_radius)] = np.asarray(sph_radius, np.float32)
        sph_model_arr[: len(sph_radius)] = np.asarray(sph_model, np.int32)

    # Sphere shading rows appended to sl_attr: closest_hit reports sphere
    # hits with packed = sph_row_base + prim, so one wide gather serves both
    # primitive kinds (geometry columns stay zero — sphere shading derives
    # them analytically).
    sph_row_base = sl_attr.shape[0]
    sph_rows = np.zeros((n_sph, ATTR_W), np.float32)
    if sph_radius:
        sm = np.asarray(sph_model, np.int32)
        sph_rows[: len(sph_radius), 27] = sm
        _bake_material_rows(sph_rows[: len(sph_radius)], sm, mats,
                            atlas=(atlas.offsets, atlas.widths,
                                   atlas.heights), wide=wide_mats)
    sl_attr = np.concatenate([sl_attr, sph_rows], axis=0)

    # Lights
    points = [l for l in scene.lights if isinstance(l, isf.PointLight)]
    dirs = [l for l in scene.lights if isinstance(l, isf.DirectionalLight)]
    point_pos = np.asarray([l.position for l in points], np.float32).reshape(-1, 3)
    point_color = np.asarray([l.color for l in points], np.float32).reshape(-1, 3)
    dir_dir = np.asarray([l.direction for l in dirs], np.float32).reshape(-1, 3)
    dir_color = np.asarray([l.color for l in dirs], np.float32).reshape(-1, 3)

    # Camera: ISF stores the cgmath COLUMN-major matrix (transform[i] is
    # column i; translation is transform[3][0..3], ref camera.rs:42-48).
    # Transpose into a conventional row-major world-from-camera matrix.
    cam = np.asarray(scene.camera.transform, np.float32).T

    atlas_data = np.concatenate(atlas.chunks, axis=0)
    sl_bw_np = _baldwin_weber_rows(sl_tris)
    (tr_bw_np, tr_rows_np, tr_grp_np, tr_colmap_np, tr_model_np,
     tr_tex8_np, tr_lut_np, tr_pages, tr_textured, tr_kernel_ok) = \
        _build_tr_walk_tables(
            sl_bw_np, sl_attr, sl_tris, nblk_op, n_blocks, SL_BLOCK,
            atlas_data, atlas.offsets, atlas.widths, atlas.heights)

    import jax.numpy as jnp

    # Pack spheres from the HOST arrays before any jnp conversion, so the
    # build never round-trips through the device.
    sph_packed_t_np = _pack_spheres(centers, radii)
    (sph_sorted_np, sph_blk_np, sph_blkid_np, sph_smap_np,
     sph_use_blocks) = _sphere_blocks(centers, radii)

    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))
    i32 = lambda x: jnp.asarray(np.asarray(x, np.int32))
    v0, e1, e2, uv0, uv1, uv2, tangent = map(
        jnp.asarray, (v0, e1, e2, uv0, uv1, uv2, tangent)
    )
    tri_model_arr = jnp.asarray(tri_model_arr)
    centers, radii, sph_model_arr = map(jnp.asarray, (centers, radii, sph_model_arr))
    point_pos, point_color, dir_dir, dir_color = map(
        jnp.asarray, (point_pos, point_color, dir_dir, dir_color)
    )
    cam = jnp.asarray(cam)
    atlas_data = jnp.asarray(atlas_data)
    return DeviceScene(
        tri_v0=v0, tri_e1=e1, tri_e2=e2,
        tri_n0=f32(n0), tri_n1=f32(n1), tri_n2=f32(n2),
        tri_uv0=uv0, tri_uv1=uv1, tri_uv2=uv2,
        tri_tangent=tangent, tri_model=tri_model_arr,
        sph_center=centers, sph_radius=radii, sph_model=sph_model_arr,
        mat_albedo_factor=f32(mats["albedo_f"]).reshape(-1, 3),
        mat_emissive_factor=f32(mats["emissive_f"]).reshape(-1, 3),
        mat_opacity_factor=f32(mats["opacity_f"]),
        mat_metalness_factor=f32(mats["metal_f"]),
        mat_roughness_factor=f32(mats["rough_f"]),
        mat_ior=f32(mats["ior"]),
        mat_albedo_tex=i32(mats["albedo_t"]),
        mat_emissive_tex=i32(mats["emissive_t"]),
        mat_opacity_tex=i32(mats["opacity_t"]),
        mat_metalness_tex=i32(mats["metal_t"]),
        mat_roughness_tex=i32(mats["rough_t"]),
        mat_normal_tex=i32(mats["normal_t"]),
        tex_data=atlas_data,
        tex_wide=jnp.asarray(tex_wide_np),
        wide_covered=wide_covered,
        tex_offset=i32(atlas.offsets),
        tex_width=i32(atlas.widths),
        tex_height=i32(atlas.heights),
        point_pos=point_pos, point_color=point_color,
        dir_dir=dir_dir, dir_color=dir_color,
        cam_to_world=cam, cam_fov=f32(scene.camera.fov),
        background=f32(scene.background),
        all_opaque=all(
            m.material.opacity.factor >= 1.0 and m.material.opacity.texture is None
            for m in scene.models
        ),
        no_emissive=all(
            tuple(m.material.emissive.factor) == (0.0, 0.0, 0.0)
            and m.material.emissive.texture is None
            for m in scene.models
        ),
        bvh_nodes=jnp.asarray(bvh_nodes),
        bvh_nodes_i=jnp.asarray(
            np.stack([bvh_nodes[:, 6].view(np.int32),
                      bvh_nodes[:, 7].view(np.int32)], axis=1)
        ),
        bvh_nodes_tr=jnp.asarray(bvh_nodes_tr),
        bvh_tris=jnp.asarray(bvh_tris),
        tri_packed_t=jnp.asarray(
            np.ascontiguousarray(bvh_tris[:n_pad].T)
        ),
        sl_nodes6=jnp.asarray(sl_nodes6),
        sl_meta6=jnp.asarray(sl_meta6),
        sl_tris_t=jnp.asarray(np.concatenate(
            [np.ascontiguousarray(sl_tris.T),
             np.zeros((7, sl_tris.shape[0]), np.float32)], axis=0)),
        sl_bw_t=jnp.asarray(sl_bw_np),
        sl_map=jnp.asarray(sl_map),
        sl_blkflat=jnp.asarray(sl_blkflat),
        sl_blkid=jnp.asarray(sl_blkid),
        sl_sbflat=jnp.asarray(sl_sbflat),
        sl_sbid=jnp.asarray(sl_sbid),
        sl_attr=jnp.asarray(sl_attr),
        sl_inv=jnp.asarray(sl_inv),
        sph_packed_t=jnp.asarray(sph_packed_t_np),
        sph_sorted_t=jnp.asarray(sph_sorted_np),
        sph_blk=jnp.asarray(sph_blk_np),
        sph_blkid=jnp.asarray(sph_blkid_np),
        sph_smap=jnp.asarray(sph_smap_np),
        sph_use_blocks=sph_use_blocks,
        tr_prefilter=jnp.asarray(tr_prefilter),
        tr_bw=jnp.asarray(tr_bw_np),
        tr_rows=jnp.asarray(tr_rows_np),
        tr_grp=jnp.asarray(tr_grp_np),
        tr_colmap=jnp.asarray(tr_colmap_np),
        tr_model=jnp.asarray(tr_model_np),
        tr_tex8=jnp.asarray(tr_tex8_np, jnp.bfloat16),
        tr_lut=jnp.asarray(tr_lut_np),
        tr_kernel_ok=tr_kernel_ok,
        tr_pages=tr_pages,
        tr_textured=tr_textured,
        no_textures=len(atlas.offsets) == 1,
        # Reading atlas geometry from the wide row instead of the three
        # tiny offset/width/height tables lost end to end on the earlier
        # accelerator; not measured on the GPU. Off-by-default knob.
        attr_tex_baked=(os.environ.get("PT_BAKED_TEX") == "1"
                        and atlas.next_offset < (1 << 24)),
        has_tex=tuple(
            any(t >= 0 for t in mats[k])
            for k in ("albedo_t", "emissive_t", "opacity_t",
                      "metal_t", "rough_t", "normal_t")),
        num_transparent_hits=n_transparent_hits,
        num_real_triangles=n_tris,
        num_real_spheres=len(sph_radius),
        sph_row_base=sph_row_base,
        bvh_leaf_size=leaf_size,
        bvh_n_nodes=nn,
        sl_n_nodes=nsl,
        sl_block=SL_BLOCK,
        sl_n_blocks=n_blocks,
        n_tris_opaque=n_op_tris,
        sl_n_blocks_opaque=nblk_op,
        sl_cols_opaque=cols_op,
        bvh_n_nodes_opaque=bvh_n_nodes_opaque,
        bvh_n_nodes_tr=bvh_n_nodes_tr,
        sph_all_opaque=sph_all_opaque,
        # Small scenes scan all triangles (XLA fuses the block scan); large
        # ones walk the BVH. Auto threshold between the head mesh (2.5k)
        # and showcase scale.
        use_bvh=use_bvh if use_bvh is not None else n_tris >= 4096,
    )


# ---------------------------------------------------------------------------
# Opacity-partition views
# ---------------------------------------------------------------------------


def partitioned(scene) -> bool:
    """True when the opacity-partitioned fast path applies: the scene has
    BOTH opaque and possibly-transparent triangles, every sphere is opaque,
    and the BVH path is in use. The integrator then replaces the generic
    sorted-hit walks with: one cast against the opaque subset (terminator /
    binary any-hit) + a bounded walk over only the transparent subset —
    semantically identical to the reference's full sorted-hit iteration
    (ref mod.rs:188-205, 283-331), and far cheaper on textured-alpha scenes
    because only the small transparent subset is walked repeatedly.
    PT_NO_PARTITION=1 forces the generic walk (A/B + parity testing)."""
    import os

    return bool(getattr(scene, "use_bvh", False)
                and not scene.all_opaque
                and scene.sph_all_opaque
                and scene.sl_n_blocks_opaque > 0
                and scene.sl_n_blocks > scene.sl_n_blocks_opaque
                and os.environ.get("PT_NO_PARTITION") != "1")


def opaque_view(scene):
    """A DeviceScene view whose triangle acceleration structures cover ONLY
    the opaque partition (spheres and every other table unchanged; block ids
    and prim ids stay global, so hit records index the shared sl_attr /
    triangle arrays directly)."""
    c = scene.sl_cols_opaque
    return dataclasses.replace(
        scene,
        sl_blkflat=scene.sl_blkflat[:, :c],
        sl_blkid=scene.sl_blkid[:, :c],
        sl_sbflat=_pad_cols(scene.sl_sbflat[:, : c // 128], 0.0),
        sl_sbid=_pad_cols(scene.sl_sbid[:, : c // 128], -1),
        sl_n_blocks=scene.sl_n_blocks_opaque,
        bvh_n_nodes=scene.bvh_n_nodes_opaque,
    )


def transparent_view(scene):
    """DeviceScene view over ONLY the possibly-transparent triangles."""
    import jax.numpy as jnp  # noqa: F401

    c = scene.sl_cols_opaque
    ct = scene.sl_blkflat.shape[1] - c
    nsb = max(1, ct // 128)
    return dataclasses.replace(
        scene,
        sl_blkflat=scene.sl_blkflat[:, c : c + ct],
        sl_blkid=scene.sl_blkid[:, c : c + ct],
        sl_sbflat=_pad_cols(scene.sl_sbflat[:, c // 128 : c // 128 + nsb], 0.0),
        sl_sbid=_pad_cols(scene.sl_sbid[:, c // 128 : c // 128 + nsb], -1),
        sl_n_blocks=scene.sl_n_blocks - scene.sl_n_blocks_opaque,
        bvh_nodes=scene.bvh_nodes_tr,
        bvh_n_nodes=scene.bvh_n_nodes_tr,
    )


def _pad_cols(arr, fill):
    """Pad the last dim up to a 128 multiple (>=128) with ``fill``."""
    import jax.numpy as jnp

    n = arr.shape[-1]
    target = max(128, ((n + 127) // 128) * 128)
    if n == target:
        return arr
    return jnp.pad(arr, [(0, 0)] * (arr.ndim - 1) + [(0, target - n)],
                   constant_values=fill)
