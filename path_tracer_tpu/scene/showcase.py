"""Procedural PS5-class showcase scene (~100k triangles).

The reference's showcase render (README.md:14-15, readme/ps5_b5_s128.png) is
a PS5 glTF scene that is NOT in its repo — only the rendered PNG. BASELINE.md
still anchors the north-star metric to a "PS5-class" scene at 1080p,
5 bounces, 128 spp. This module generates a deterministic equivalent-scale
scene: a fractal-noise terrain mesh (2*G*G triangles), a grid of glossy/metal
spheres, emissive accents, and mixed point/directional lighting.

``textured=True`` (the bench default since round 3) additionally exercises
every material-texture path the reference supports on its own showcase-class
scenes (ref tests/scenes/head: 1024^2 albedo+alpha textures; gltf.rs
converter emits albedo/metal-rough/normal/emissive/alpha textures):

- terrain: 1024^2 albedo + 512^2 tangent-space normal map + 512^2 roughness,
- foliage cards with a stochastic-alpha cutout texture (opacity channel),
- an emissive-textured billboard (the emissive-not-linearized quirk path).

Textures are generated procedurally (deterministic, u8 PNG round-trip) into
a cache directory so the scene stays reproducible with no binary assets in
the repo; ``write_showcase_scene_dir`` materializes scene.isf + PNGs for the
CLI / oracle tools.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from path_tracer_tpu.scene import isf

TEX_VERSION = "v2"


def _value_noise(grid: int, octaves: int, seed: int) -> np.ndarray:
    """[grid+1, grid+1] fractal value noise in [0, 1]."""
    rng = np.random.default_rng(seed)
    h = np.zeros((grid + 1, grid + 1))
    for o in range(octaves):
        step = max(1, grid >> o)
        n = grid // step + 2
        coarse = rng.standard_normal((n, n))
        # bilinear upsample to grid+1
        ys = np.linspace(0, n - 1.001, grid + 1)
        xs = np.linspace(0, n - 1.001, grid + 1)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        c = (coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
             + coarse[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
             + coarse[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
             + coarse[np.ix_(y0 + 1, x0 + 1)] * fy * fx)
        h += c * (0.5 ** o)
    h -= h.min()
    h /= max(h.max(), 1e-9)
    return h


def _tile_noise(size: int, octaves: int, seed: int) -> np.ndarray:
    """[size, size] fractal value noise in [0, 1] that WRAPS (for textures)."""
    rng = np.random.default_rng(seed)
    h = np.zeros((size, size))
    for o in range(octaves):
        n = min(size, 4 << o)
        coarse = rng.standard_normal((n, n))
        reps = size // n
        # nearest-neighbor tile + box blur for cheap periodic smoothness
        up = np.repeat(np.repeat(coarse, reps, axis=0), reps, axis=1)
        k = max(1, reps // 2)
        if k > 1:
            up = sum(np.roll(up, s, axis=0) for s in range(-k, k + 1)) / (2 * k + 1)
            up = sum(np.roll(up, s, axis=1) for s in range(-k, k + 1)) / (2 * k + 1)
        h += up * (0.55 ** o)
    h -= h.min()
    h /= max(h.max(), 1e-9)
    return h


def _save_u8(arr01: np.ndarray, path: Path) -> None:
    """Write a [H,W] gray or [H,W,3] RGB array in [0,1] as an 8-bit PNG."""
    from path_tracer_tpu.utils.image_io import save_png

    save_png(np.clip(arr01 * 255.0 + 0.5, 0, 255).astype(np.uint8), path)


def leaf_alpha_mask(s: int = 256) -> np.ndarray:
    """[s,s] leaf alpha-cutout mask in [0,1] (shared by the texture writer
    and the card-cell culling in showcase_scene — the PNG stores exactly
    this array, u8-quantized)."""
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float64) / (s - 1)
    cx, cy = xx - 0.5, yy - 0.55
    r_ell = np.sqrt((cx / 0.38) ** 2 + (cy / 0.45) ** 2)
    jag = 0.08 * np.sin(np.arctan2(cy, cx) * 9.0)
    mask = np.clip((1.0 + jag - r_ell) / 0.12, 0.0, 1.0)
    stem = (np.abs(cx) < 0.02) & (cy > 0.2) & (cy < 0.52)
    return np.maximum(mask, stem * 1.0)


def generate_showcase_textures(out_dir) -> None:
    """Write the deterministic showcase texture set into ``out_dir``
    (idempotent: skipped when the version marker exists)."""
    out = Path(out_dir)
    marker = out / f".done_{TEX_VERSION}"
    if marker.exists():
        return
    out.mkdir(parents=True, exist_ok=True)

    # Terrain albedo 1024^2: grass/rock blend by low-freq noise + detail.
    n1 = _tile_noise(1024, 6, 101)
    n2 = _tile_noise(1024, 8, 102)
    grass = np.array([0.13, 0.30, 0.10])
    rock = np.array([0.42, 0.39, 0.34])
    base = grass[None, None] * (1 - n1[..., None]) + rock[None, None] * n1[..., None]
    albedo = np.clip(base * (0.75 + 0.5 * n2[..., None]), 0.0, 1.0)
    # Albedo textures are sRGB: the sampler linearizes texels with pow 2.2
    # (ref material.rs:137-141), so the PNG stores the 1/2.2 encoding of the
    # intended linear color.
    _save_u8(albedo ** (1 / 2.2), out / "terrain_albedo.png")

    # Terrain normal map 512^2 from a noise heightfield (tangent space,
    # decoded px/127.5-1 by the sampler — ref material.rs:178-187).
    hf = _tile_noise(512, 7, 103)
    gx = (np.roll(hf, -1, axis=1) - np.roll(hf, 1, axis=1)) * 0.5
    gy = (np.roll(hf, -1, axis=0) - np.roll(hf, 1, axis=0)) * 0.5
    amp = 24.0
    nrm = np.stack([-gx * amp, -gy * amp, np.ones_like(hf)], axis=-1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    _save_u8(nrm * 0.5 + 0.5, out / "terrain_normal.png")

    # Terrain roughness 512^2 gray in [0.45, 0.95].
    rough = 0.45 + 0.5 * _tile_noise(512, 5, 104)
    _save_u8(rough, out / "terrain_rough.png")

    # Leaf card albedo + alpha cutout 256^2. The alpha mask is mostly hard
    # (0/1) with a soft rim so the stochastic accept test (op in (0.001, 1))
    # actually runs on edge texels (ref mod.rs:188-205).
    s = 256
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float64) / (s - 1)
    cx, cy = xx - 0.5, yy - 0.55
    alpha = leaf_alpha_mask()
    _save_u8(alpha, out / "leaf_alpha.png")
    vein = np.clip(1.0 - 6.0 * np.abs(cx - 0.25 * cy * np.sin(cy * 7)), 0, 1)
    leaf_rgb = np.stack([
        0.10 + 0.12 * vein, 0.34 + 0.25 * vein * (1 - yy * 0.5),
        0.06 + 0.08 * vein], axis=-1)
    _save_u8(np.clip(leaf_rgb, 0, 1) ** (1 / 2.2), out / "leaf_albedo.png")

    # Emissive billboard 256x128: bright diagonal stripes. The emissive
    # texture is sampled WITHOUT sRGB linearization (ref quirk,
    # material.rs:189-201); the factor scales it well above 1.
    bh, bw = 128, 256
    yy2, xx2 = np.mgrid[0:bh, 0:bw].astype(np.float64)
    stripe = 0.5 + 0.5 * np.sin((xx2 + 2 * yy2) * 0.12)
    emis = np.stack([stripe, 0.4 + 0.6 * stripe ** 2,
                     1.0 - 0.7 * stripe], axis=-1)
    _save_u8(np.clip(emis, 0, 1), out / "billboard_emissive.png")

    marker.touch()


def default_texture_dir() -> Path:
    from path_tracer_tpu.utils.cache import cache_dir

    return cache_dir(f"showcase_tex_{TEX_VERSION}")


def showcase_scene(grid: int = 224, seed: int = 7,
                   textured: bool = False) -> isf.Scene:
    """~2*grid^2 terrain triangles + 48 spheres (default ~100k tris).

    ``textured=True`` adds the texture set (terrain albedo/normal/roughness,
    alpha-cutout foliage cards, an emissive billboard); texture paths are
    relative to ``default_texture_dir()`` — use showcase_device_scene or
    write_showcase_scene_dir, which pass the right root."""
    size = 40.0
    height = 6.0
    h = _value_noise(grid, octaves=6, seed=seed) * height

    xs = np.linspace(-size / 2, size / 2, grid + 1)
    zs = np.linspace(-size / 2, size / 2, grid + 1)
    px, pz = np.meshgrid(xs, zs, indexing="ij")
    pos = np.stack([px, h, pz], axis=-1)  # [G+1,G+1,3]

    # Vertex normals from central differences.
    gy, gx = np.gradient(h)
    n = np.stack([-gx, np.ones_like(h) * (size / grid), -gy], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)

    uu, vv = np.meshgrid(np.linspace(0, 8, grid + 1),
                         np.linspace(0, 8, grid + 1), indexing="ij")

    def vert(i, j):
        return isf.Vertex(
            position=tuple(float(c) for c in pos[i, j]),
            normal=tuple(float(c) for c in n[i, j]),
            tex_coords=(float(uu[i, j]), float(vv[i, j])),
        )

    tris = []
    for i in range(grid):
        for j in range(grid):
            v00, v10 = vert(i, j), vert(i + 1, j)
            v01, v11 = vert(i, j + 1), vert(i + 1, j + 1)
            # Wound so the geometric normal (e1 x e2) points UP (+y): with
            # i->x and j->z, (v00,v11,v10) gives e1 x e2 = (0, dx*dz, 0).
            # (Round-2 wound these downward, so every camera hit was a
            # backface whose flipped shading normal faced away from every
            # light — the terrain rendered black and its shadow lanes were
            # artificially cheap.)
            tris.append((v00, v11, v10))
            tris.append((v00, v01, v11))

    if textured:
        terrain_mat = isf.Material(
            albedo=isf.Channel3(factor=(1.0, 1.0, 1.0),
                                texture="terrain_albedo.png"),
            emissive=isf.Channel3(factor=(0.0, 0.0, 0.0)),
            opacity=isf.Channel1(factor=1.0),
            metalness=isf.Channel1(factor=0.0),
            roughness=isf.Channel1(factor=1.0, texture="terrain_rough.png"),
            normal_texture="terrain_normal.png",
        )
    else:
        terrain_mat = isf.Material(
            albedo=isf.Channel3(factor=(0.45, 0.38, 0.30)),
            emissive=isf.Channel3(factor=(0.0, 0.0, 0.0)),
            opacity=isf.Channel1(factor=1.0),
            metalness=isf.Channel1(factor=0.0),
            roughness=isf.Channel1(factor=0.85),
        )
    terrain = isf.Mesh(triangles=tris, material=terrain_mat)

    rng = np.random.default_rng(seed + 1)
    models: list = [terrain]

    def terrain_y(x, z):
        gi = min(int((x + size / 2) / size * grid), grid)
        gj = min(int((z + size / 2) / size * grid), grid)
        return float(h[gi, gj])

    if textured:
        # Foliage: alpha-cutout cards standing on the terrain — the
        # stochastic-alpha walk (ref mod.rs:188-205) and opacity-attenuated
        # shadows (mod.rs:283-331) run on the BENCH path, not just on tiny
        # test scenes. One Mesh = one material, like the converter's output.
        card_rng = np.random.default_rng(seed + 2)
        card_tris = []
        # Cards are TESSELLATED into CELLS x CELLS sub-quads, and cells whose
        # alpha footprint is entirely 0 are simply not authored (standard
        # alpha-tested foliage meshing). Interior cells whose footprint is
        # entirely 1 stay in this (transparent-material) mesh but the scene
        # builder's per-triangle classification moves them to the OPAQUE
        # partition — only the cutout RIM cells need the stochastic walk.
        CELLS = 1  # tessellated cells lost end to end on the earlier accelerator
        amask = leaf_alpha_mask()
        ah, aw = amask.shape
        cell_max = np.zeros((CELLS, CELLS))
        for ci in range(CELLS):
            for cj in range(CELLS):
                xs = slice(int(ci / CELLS * aw), int((ci + 1) / CELLS * aw) + 1)
                ys = slice(int(cj / CELLS * ah), int((cj + 1) / CELLS * ah) + 1)
                cell_max[ci, cj] = amask[ys, xs].max()
        for _ in range(300):
            x, z = card_rng.uniform(-size / 2.2, size / 2.2, 2)
            y0 = terrain_y(x, z) - 0.05
            ch = float(card_rng.uniform(0.8, 2.2))  # card height
            cw = ch * 0.75
            yaw = float(card_rng.uniform(0, math.pi))
            rx, rz = math.cos(yaw), math.sin(yaw)
            nx, nz = -rz, rx  # horizontal normal

            def cvert(u, v):
                # u across the card width, v DOWN the texture (v=1 bottom).
                off = (u - 0.5) * cw
                return isf.Vertex(
                    position=(float(x + rx * off), float(y0 + (1.0 - v) * ch),
                              float(z + rz * off)),
                    normal=(nx, 0.0, nz), tex_coords=(float(u), float(v)))

            for ci in range(CELLS):
                for cj in range(CELLS):
                    if cell_max[ci, cj] <= 0.0:
                        continue  # fully-cutout cell: not authored
                    u0, u1 = ci / CELLS, (ci + 1) / CELLS
                    v0_, v1_ = cj / CELLS, (cj + 1) / CELLS
                    a = cvert(u0, v1_)
                    b = cvert(u1, v1_)
                    c = cvert(u1, v0_)
                    e = cvert(u0, v0_)
                    card_tris.append((a, b, c))
                    card_tris.append((a, c, e))
        models.append(isf.Mesh(
            triangles=card_tris,
            material=isf.Material(
                albedo=isf.Channel3(factor=(1.0, 1.0, 1.0),
                                    texture="leaf_albedo.png"),
                emissive=isf.Channel3(factor=(0.0, 0.0, 0.0)),
                opacity=isf.Channel1(factor=1.0, texture="leaf_alpha.png"),
                metalness=isf.Channel1(factor=0.0),
                roughness=isf.Channel1(factor=0.9),
            ),
        ))

        # Emissive-textured billboard (emissive texels are NOT sRGB-decoded
        # — ref material.rs:189-201 quirk — and the factor scales them hot).
        bx, bz = 6.0, -8.0
        by = terrain_y(bx, bz) + 1.0
        bw_, bh_ = 6.0, 3.0

        def bvert(p, u, v):
            return isf.Vertex(position=tuple(float(q) for q in p),
                              normal=(0.0, 0.0, 1.0), tex_coords=(u, v))

        b00 = bvert((bx - bw_ / 2, by, bz), 0.0, 1.0)
        b10 = bvert((bx + bw_ / 2, by, bz), 1.0, 1.0)
        b11 = bvert((bx + bw_ / 2, by + bh_, bz), 1.0, 0.0)
        b01 = bvert((bx - bw_ / 2, by + bh_, bz), 0.0, 0.0)
        models.append(isf.Mesh(
            triangles=[(b00, b10, b11), (b00, b11, b01)],
            material=isf.Material(
                albedo=isf.Channel3(factor=(0.05, 0.05, 0.05)),
                emissive=isf.Channel3(factor=(6.0, 6.0, 6.0),
                                      texture="billboard_emissive.png"),
                opacity=isf.Channel1(factor=1.0),
                metalness=isf.Channel1(factor=0.0),
                roughness=isf.Channel1(factor=0.8),
            ),
        ))
    for k in range(48):
        x, z = rng.uniform(-size / 2.5, size / 2.5, 2)
        gi = int((x + size / 2) / size * grid)
        gj = int((z + size / 2) / size * grid)
        r = float(rng.uniform(0.4, 1.4))
        y = float(h[min(gi, grid), min(gj, grid)]) + r
        metal = float(rng.uniform(0, 1) > 0.5)
        rough = float(rng.uniform(0.02, 0.6))
        emis = (0.0, 0.0, 0.0)
        if k % 11 == 0:
            emis = tuple(float(c) for c in rng.uniform(2, 8, 3))
        models.append(isf.Sphere(
            radius=r, center=(float(x), y, float(z)),
            material=isf.Material(
                albedo=isf.Channel3(factor=tuple(
                    float(c) for c in rng.uniform(0.3, 0.95, 3))),
                emissive=isf.Channel3(factor=emis),
                opacity=isf.Channel1(factor=1.0),
                metalness=isf.Channel1(factor=metal),
                roughness=isf.Channel1(factor=rough),
            ),
        ))

    cam_pos = (0.0, height + 6.0, size / 2 + 6.0)
    pitch = -0.45
    cp, sp = math.cos(pitch), math.sin(pitch)
    # Column-major: columns are the camera basis vectors; look down -z
    # tilted toward the terrain.
    transform = [
        [1.0, 0.0, 0.0, 0.0],
        [0.0, cp, sp, 0.0],
        [0.0, -sp, cp, 0.0],
        [cam_pos[0], cam_pos[1], cam_pos[2], 1.0],
    ]
    camera = isf.Camera(transform=transform, fov=math.radians(55),
                        zfar=200.0, znear=0.01)

    lights = [
        isf.DirectionalLight(direction=(-0.4, -1.0, -0.3),
                             color=(2.2, 2.0, 1.8)),
        isf.PointLight(position=(8.0, height + 8.0, 0.0),
                       color=(600.0, 500.0, 420.0)),
        isf.PointLight(position=(-10.0, height + 5.0, 6.0),
                       color=(220.0, 280.0, 420.0)),
    ]
    return isf.Scene(models=models, camera=camera, lights=lights,
                     background=(0.35, 0.45, 0.65))


def showcase_device_scene(grid: int = 224, use_bvh=None, sl_block: int = 512,
                          textured: bool = False):
    from path_tracer_tpu.scene.device_scene import build_device_scene

    root = "."
    if textured:
        root = default_texture_dir()
        generate_showcase_textures(root)
    return build_device_scene(showcase_scene(grid, textured=textured),
                              root=root, use_bvh=use_bvh, sl_block=sl_block)


def write_showcase_scene_dir(out_dir, grid: int = 224,
                             textured: bool = True) -> Path:
    """Materialize the showcase as an on-disk ISF scene directory
    (scene.isf + texture PNGs) for the CLI / oracle tools. Returns the
    scene.isf path."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if textured:
        generate_showcase_textures(out)
    path = out / "scene.isf"
    isf.save(showcase_scene(grid, textured=textured), path)
    return path
