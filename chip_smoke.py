"""Smoke test of the path tracer on one NVIDIA GPU (or four, --multi-gpu).

Drives the main path through the entry points a user calls, at full size,
and checks the results by the repo's own means:

1. device  — JAX must see a GPU (never carries on on the CPU); prints the
             card's name and power limit, device kind, versions and the
             compile-cache directory.
2. oracle  — the 11 oracle-golden scenes rendered on the GPU against the
             independent scalar oracle, with the CPU gate's tolerances
             (tests/tools/oracle_check.py).
3. kernel  — each Triton BVH kernel (ops/bvh_triton.py), compiled for the
             card, against the plain jnp walk at 2^19 rays on the textured
             showcase, with their times.
4. render  — ``path-tracer-tpu render`` (cli.main) of the textured showcase
             (~100k triangles, spheres, 3 lights, textures, alpha foliage)
             at 1920x1080, 5 bounces, 4 spp, cold and warm.
5. train   — one make_train_step step on a 2^18-lane 1080p tile of the
             textured showcase, plus gradient-vs-finite-difference checks.

    python chip_smoke.py              # one GPU, all phases
    python chip_smoke.py --multi-gpu  # four GPUs: sharded render + train
                                      # step vs one device, nothing else

Any failing phase raises, so the script exits non-zero; only a fully
passing run prints the final JSON line
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

WIDTH, HEIGHT = 1920, 1080
BOUNCES = 5
KERNEL_RAYS = 1 << 19
TRAIN_RAYS = 1 << 18

# Kernel vs plain walk, compiled: FMA contraction moves Moller-Trumbore
# terms by ulps, which can flip grazing hits (u, v or t on a test boundary).
MAX_DISAGREE = 1e-4  # fraction of rays whose kind/prim (or occlusion) differ
MAX_REL_DT = 1e-5  # |dt|/t on rays that agree
MIN_T_REL = 0.1  # smallest t the relative check applies to (~ an edge)
FD_RTOL = 0.05  # analytic gradient vs central finite difference


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _phase(name: str):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def _done(name: str, t0: float) -> None:
    print(f"== {name}: OK ({time.perf_counter() - t0:.1f} s)", flush=True)


def _timed(fn, *args, reps: int = 5):
    """(result, first-call seconds incl. compile, sorted warm seconds)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        warm.append(time.perf_counter() - t0)
    return out, first, sorted(warm)


def phase_device(n_expected: int) -> tuple[str, str]:
    """Require n_expected GPUs; print what the card and JAX are. Returns
    (card line from nvidia-smi, device kind)."""
    import jax
    import jaxlib

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found (JAX platform "
                         f"{devs[0].platform!r}); nothing was run")
    if len(devs) < n_expected:
        raise SystemExit(f"chip_smoke: needs {n_expected} GPUs, JAX sees "
                         f"{len(devs)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    from path_tracer_tpu.utils.cache import enable_compilation_cache

    cache = enable_compilation_cache()
    print(card)  # nvidia-smi's own name, power.limit line(s)
    print(f"device_kind: {devs[0].device_kind} x{len(devs)}")
    print(f"jax {jax.__version__} jaxlib {jaxlib.__version__}")
    print(f"compile cache: {cache}", flush=True)
    return card.splitlines()[0], devs[0].device_kind


def phase_oracle(cases=None) -> None:
    from tests.tools.oracle_check import DEFAULT_CASES, check_cases

    failures = check_cases(cases or DEFAULT_CASES)
    check(not failures, f"oracle cases failed: {failures}")


def _camera_and_bounce_rays(scene, width, height, n):
    """Camera rays of n mid-frame pixels (host Morton order, as the renderer
    feeds them), their closest plain-walk hits, and one diffuse-ish bounce
    ray per hit (miss lanes dead)."""
    import jax
    import jax.numpy as jnp

    from path_tracer_tpu.ops.bvh_traverse import closest_hit_triangles_bvh
    from path_tracer_tpu.ops.camera import generate_rays
    from path_tracer_tpu.ops.sorting import morton_pixel_order

    order = morton_pixel_order(width, height)
    start = min(len(order) - n, len(order) // 2 - n // 2)
    ids = jnp.asarray(order[start : start + n])
    o, d = generate_rays(ids, width, height, scene, jnp.int32(1), 0)
    hit = jax.jit(closest_hit_triangles_bvh)(
        o, d, jnp.full((n,), -1.0, jnp.float32), scene)
    pos = o + d * jnp.where(hit.valid, hit.t, 0.0)[:, None]
    key = jax.random.PRNGKey(7)
    rd = jax.random.normal(key, (n, 3))
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    rd = jnp.where((rd[:, 1:2] < 0.0), rd * jnp.array([1.0, -1.0, 1.0]), rd)
    o2 = pos + jnp.array([0.0, 1e-3, 0.0])
    return (o, d), (o2, rd, hit.valid)


def _compare_hits(name, plain, kern):
    ka, kb = np.asarray(plain.kind), np.asarray(kern.kind)
    pa, pb = np.asarray(plain.prim), np.asarray(kern.prim)
    differ = (ka != kb) | ((ka > 0) & (pa != pb))
    # |dt|/t is taken over agreeing hits with t >= MIN_T_REL: the rounding
    # error of Moller-Trumbore's t scales with the edge length, not with t,
    # so for a hit much closer than a triangle's size (a bounce ray leaving
    # a surface) an ulp of the edge terms is a large fraction of t.
    ta, tb = np.asarray(plain.t), np.asarray(kern.t)
    same = (ka > 0) & ~differ & (ta >= MIN_T_REL)
    rel = (float(np.max(np.abs(ta[same] - tb[same]) / ta[same]))
           if same.any() else 0.0)
    frac = float(differ.mean())
    print(f"  {name}: hit fraction {float((ka > 0).mean()):.4f}, "
          f"kind/prim disagree {frac:.2e} (tol {MAX_DISAGREE:.0e}), "
          f"max |dt|/t {rel:.2e} over hits with t >= {MIN_T_REL} "
          f"(tol {MAX_REL_DT:.0e})", flush=True)
    check(frac <= MAX_DISAGREE, f"{name}: {frac} of rays disagree")
    check(rel <= MAX_REL_DT, f"{name}: |dt|/t {rel}")


def phase_kernel(scene, n_rays: int = KERNEL_RAYS, reps: int = 5,
                 interpret: bool = False) -> dict:
    """Each Triton kernel vs the plain jnp walk, compiled, at n_rays."""
    import functools

    import jax
    import jax.numpy as jnp

    from path_tracer_tpu.ops import bvh_triton
    from path_tracer_tpu.ops.bvh_traverse import closest_hit_triangles_bvh
    from path_tracer_tpu.scene.device_scene import (
        opaque_view,
        transparent_view,
    )

    print(f"  precision: float32 throughout (no matmul); tolerances above; "
          f"{n_rays} rays, block {bvh_triton.BLOCK_RAYS}", flush=True)
    plain = jax.jit(closest_hit_triangles_bvh)
    kern = jax.jit(functools.partial(
        bvh_triton.closest_hit_triangles_kernel, interpret=interpret))
    occ_kern = jax.jit(functools.partial(
        bvh_triton.occluded_triangles_kernel, interpret=interpret))

    @jax.jit
    def occ_plain(o, d, t_max, s):
        h = closest_hit_triangles_bvh(
            o, d, jnp.where(t_max < 0.0, jnp.inf, -1.0), s)
        return h.valid & (h.t <= t_max)

    (o, d), (o2, d2, live) = _camera_and_bounce_rays(
        scene, WIDTH, HEIGHT, n_rays)
    t_fresh = jnp.full((n_rays,), -1.0, jnp.float32)
    t_bounce = jnp.where(live, -1.0, jnp.inf)
    times = {}

    def run(name, args):
        a, _, ta = _timed(plain, *args, reps=reps)
        b, first, tb = _timed(kern, *args, reps=reps)
        _compare_hits(name, a, b)
        times[name] = (ta[len(ta) // 2], tb[len(tb) // 2])
        print(f"  {name}: plain walk {ta[len(ta) // 2] * 1e3:.3f} ms, "
              f"kernel {tb[len(tb) // 2] * 1e3:.3f} ms "
              f"(first call {first:.2f} s)", flush=True)

    run("closest primary", (o, d, t_fresh, scene))
    run("closest bounce", (o2, d2, t_bounce, scene))
    tv = transparent_view(scene)
    run("closest bounce, transparent view", (o2, d2, t_bounce, tv))

    # Any hit: toward each point light (range-limited, dead lanes -1) and
    # along the bounce rays with no range limit.
    ov = opaque_view(scene)
    sets = []
    for li in range(scene.num_point_lights):
        to_l = scene.point_pos[li] - o2
        dist = jnp.linalg.norm(to_l, axis=-1)
        sets.append((f"any-hit light {li}", o2, to_l / dist[:, None],
                     jnp.where(live, dist, -1.0)))
    sets.append(("any-hit bounce", o2, d2,
                 jnp.where(live, jnp.inf, -1.0)))
    for name, oo, dd, tm in sets:
        a, _, ta = _timed(occ_plain, oo, dd, tm, ov, reps=reps)
        b, first, tb = _timed(occ_kern, oo, dd, tm, ov, reps=reps)
        frac = float((np.asarray(a) != np.asarray(b)).mean())
        times[name] = (ta[len(ta) // 2], tb[len(tb) // 2])
        print(f"  {name} (opaque view): occluded {float(np.mean(a)):.4f}, "
              f"disagree {frac:.2e} (tol {MAX_DISAGREE:.0e}); plain walk "
              f"{ta[len(ta) // 2] * 1e3:.3f} ms, kernel "
              f"{tb[len(tb) // 2] * 1e3:.3f} ms", flush=True)
        check(frac <= MAX_DISAGREE, f"{name}: {frac} of rays disagree")
    return times


def _peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def phase_render(card: str, workdir: Path, width: int = WIDTH,
                 height: int = HEIGHT, spp: int = 4, grid: int = 224) -> None:
    """CLI render of the textured showcase, cold then warm."""
    from path_tracer_tpu import cli
    from path_tracer_tpu.scene.showcase import write_showcase_scene_dir
    from path_tracer_tpu.utils.image_io import read_png

    t0 = time.perf_counter()
    scene_path = write_showcase_scene_dir(workdir / "showcase", grid=grid,
                                          textured=True)
    print(f"  wrote {scene_path} in {time.perf_counter() - t0:.1f} s")
    profile = workdir / "profile.yaml"
    profile.write_text(f"resolution: {{width: {width}, height: {height}}}\n"
                       f"bounces: {BOUNCES}\nsamples: {spp}\n")
    rays = width * height * spp * (BOUNCES + 1)
    for label in ("cold", "warm"):
        out = workdir / f"render_{label}.png"
        t0 = time.perf_counter()
        cli.main(["render", str(scene_path), "-o", str(out), "-p",
                  str(profile), "-q"])
        wall = time.perf_counter() - t0
        img, mode = read_png(out)
        check(img.shape == (height, width, 3) and mode == "RGB",
              f"render PNG shape {img.shape} mode {mode}")
        check(np.isfinite(img.astype(np.float64)).all(), "non-finite PNG")
        spread = float(img.astype(np.float64).std())
        check(spread > 5.0, f"flat render (std {spread:.2f})")
        print(f"  {label}: {width}x{height} b{BOUNCES} spp{spp} wall "
              f"{wall:.2f} s = {rays / wall / 1e6:.2f} Mray/s (W*H*spp*(b+1) "
              f"over the whole CLI call), image std {spread:.1f}, "
              f"peak_bytes_in_use {_peak_bytes()} [{card}]", flush=True)


def _grad_fd(scene, label: str, w: int = 64, h: int = 16) -> None:
    """Analytic d(mean radiance)/d(global albedo scale) vs central FD."""
    import jax
    import jax.numpy as jnp

    from path_tracer_tpu.models.integrator import (
        IntegratorSpec,
        render_wavefront,
    )

    ids = jnp.arange(w * h, dtype=jnp.int32)
    spec = IntegratorSpec(bounces=2, alpha_walk_steps=2,
                          shadow_walk_steps=2, differentiable=True)

    @jax.jit
    def mean_rad(f):
        s2 = dataclasses.replace(
            scene, mat_albedo_factor=scene.mat_albedo_factor * f)
        return jnp.mean(render_wavefront(s2, ids, w, h, jnp.int32(1), spec))

    f0 = jnp.float32(1.0)
    g = float(jax.jit(jax.grad(mean_rad))(f0))
    eps = 5e-3
    fd = float((mean_rad(f0 + eps) - mean_rad(f0 - eps)) / (2 * eps))
    print(f"  grad vs FD ({label}): g={g:.6f} fd={fd:.6f} "
          f"(rtol {FD_RTOL})", flush=True)
    check(np.isfinite(g) and abs(fd) > 1e-6
          and abs(g - fd) <= FD_RTOL * abs(fd), f"grad vs FD ({label})")


def _train_step(scene, mesh, n_rays: int, width: int, height: int):
    """One make_train_step step on a mid-frame Morton tile; returns
    (loss, grads) with grads recovered from the SGD update."""
    import jax
    import jax.numpy as jnp

    from path_tracer_tpu.models.integrator import IntegratorSpec
    from path_tracer_tpu.ops.sorting import morton_pixel_order
    from path_tracer_tpu.parallel import get_params, make_train_step

    lr = 1.0
    order = morton_pixel_order(width, height)
    start = min(len(order) - n_rays, 4 * n_rays)
    ids = jnp.asarray(order[start : start + n_rays])
    step = make_train_step(mesh, width, height,
                           IntegratorSpec(bounces=BOUNCES), n_samples=1,
                           lr=lr)
    params = get_params(scene)
    target = jnp.full((n_rays, 3), 0.5, jnp.float32)
    new, loss = jax.block_until_ready(
        step(params, scene, ids, target, jnp.int32(1)))
    grads = {k: np.asarray(params[k]) - np.asarray(new[k]) for k in params}
    return float(loss), grads


def phase_train(scene, small_bvh_scene, small_brute_scene,
                n_rays: int = TRAIN_RAYS, width: int = WIDTH,
                height: int = HEIGHT) -> None:
    from path_tracer_tpu.parallel import default_mesh

    t0 = time.perf_counter()
    loss, grads = _train_step(scene, default_mesh(1), n_rays, width, height)
    gnorm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                              for g in grads.values())))
    finite = all(np.isfinite(g).all() for g in grads.values())
    print(f"  train step ({n_rays} lanes, {width}x{height} b{BOUNCES}): "
          f"loss {loss:.6f}, |grad| {gnorm:.6f}, "
          f"{time.perf_counter() - t0:.1f} s incl. compile; "
          f"peak_bytes_in_use {_peak_bytes()}", flush=True)
    check(np.isfinite(loss) and loss > 0.0, f"loss {loss}")
    check(finite and gnorm > 0.0, f"gradients finite={finite} |g|={gnorm}")
    _grad_fd(small_brute_scene, "brute-force scan, cornell")
    _grad_fd(small_bvh_scene, "BVH kernel path, textured showcase g96")


def _tiles(width: int, height: int, tile: int):
    from path_tracer_tpu.ops.sorting import morton_pixel_order

    order = morton_pixel_order(width, height)
    n_tiles = -(-len(order) // tile)
    ids = np.zeros(n_tiles * tile, np.int32)
    ids[: len(order)] = order
    return [ids[i * tile : (i + 1) * tile] for i in range(n_tiles)], order


def _sharded_image(scene, mesh, spp, width, height, tile, rebalance):
    import jax
    import jax.numpy as jnp

    from path_tracer_tpu.models.integrator import IntegratorSpec
    from path_tracer_tpu.parallel import render_sharded

    spec = IntegratorSpec(bounces=BOUNCES, differentiable=False)
    tiles, order = _tiles(width, height, tile)
    outs = []
    for ids in tiles:
        out = render_sharded(scene, mesh, jnp.asarray(ids), width, height,
                             jnp.int32(1), spp, spec, rebalance=rebalance)
        check(len(out.sharding.device_set) == mesh.size,
              f"output on {len(out.sharding.device_set)} devices")
        outs.append(out)
    rows = np.concatenate([np.asarray(jax.block_until_ready(x))
                           for x in outs])[: len(order)]
    img = np.empty_like(rows)
    img[order] = rows
    return img / spp


def phase_multi(scene, n_dev: int = 4, spp: int = 2, width: int = WIDTH,
                height: int = HEIGHT, tile: int = 1 << 18,
                train_rays: int = TRAIN_RAYS) -> None:
    """Sharded render (with and without the all_to_all rebalance) and a
    sharded train step on n_dev devices, each against one device."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from path_tracer_tpu.parallel import default_mesh

    mesh1, meshn = default_mesh(1), default_mesh(n_dev)
    rep = jax.device_put(scene, NamedSharding(meshn, P()))
    want = set(meshn.devices.flat)
    for leaf in jax.tree_util.tree_leaves(rep):
        have = {s.device for s in leaf.addressable_shards}
        check(have == want, f"scene leaf {leaf.shape} on {len(have)} of "
                            f"{n_dev} devices")
    print(f"  scene replicated on all {n_dev} devices "
          f"({len(jax.tree_util.tree_leaves(rep))} arrays)", flush=True)

    rays = width * height * spp * (BOUNCES + 1)

    def timed_image(s, mesh, rebalance):
        """(image, warm seconds): a cold call (compiles), then a warm one."""
        _sharded_image(s, mesh, spp, width, height, tile, rebalance)
        t0 = time.perf_counter()
        img = _sharded_image(s, mesh, spp, width, height, tile, rebalance)
        return img, time.perf_counter() - t0

    ref, t1 = timed_image(scene, mesh1, False)
    print(f"  1-device render {width}x{height} b{BOUNCES} spp{spp}: warm "
          f"{t1:.2f} s = {rays / t1 / 1e6:.2f} Mray/s", flush=True)
    for rebalance in (False, True):
        img, dt = timed_image(rep, meshn, rebalance)
        diff = np.abs(img - ref)
        frac = float((diff.max(axis=-1) > 1e-3 * (1.0 + np.abs(ref).max(
            axis=-1))).mean())
        print(f"  {n_dev}-device render, rebalance={rebalance}: warm "
              f"{dt:.2f} s = {rays / dt / 1e6:.2f} Mray/s ({t1 / dt:.2f}x "
              f"one device); pixels differing from 1 device {frac:.2e} "
              f"(tol 1e-3), mean |d| {float(diff.mean()):.2e} (tol 1e-4)",
              flush=True)
        check(np.isfinite(img).all(), "non-finite sharded render")
        check(frac <= 1e-3 and float(diff.mean()) <= 1e-4,
              f"sharded render (rebalance={rebalance}) differs")

    # The train step's loss sums 2^18 x 3 squared errors, dominated by a
    # few bright (emissive, specular) lanes; 4 devices run 2^16-lane
    # programs that XLA fuses differently from the 2^18-lane one (FMA
    # contraction can flip a grazing hit) and sum in another order, and the
    # texture gradients are GPU scatter-adds whose order is not fixed. So
    # the comparison is statistical: loss to 1e-3, gradient norm to 1e-2,
    # beside the one-device repeat as the noise floor.
    loss1, g1 = _train_step(scene, mesh1, train_rays, width, height)
    loss1b, g1b = _train_step(scene, mesh1, train_rays, width, height)
    lossn, gn = _train_step(rep, meshn, train_rays, width, height)

    def rel_grad(ga, gb):
        num = sum(float(((ga[k] - gb[k]).astype(np.float64) ** 2).sum())
                  for k in ga)
        den = sum(float((ga[k].astype(np.float64) ** 2).sum()) for k in ga)
        return float(np.sqrt(num / max(den, 1e-30)))

    per_param = sorted(
        ((float(np.linalg.norm((g1[k] - gn[k]).astype(np.float64)))
          / max(float(np.linalg.norm(g1[k].astype(np.float64))), 1e-30), k)
         for k in g1), reverse=True)[:3]
    rel_g, rel_g_floor = rel_grad(g1, gn), rel_grad(g1, g1b)
    rel_l = abs(lossn - loss1) / max(abs(loss1), 1e-30)
    print(f"  {n_dev}-device train step: loss {lossn:.6f} vs {loss1:.6f} "
          f"(rel {rel_l:.2e}, tol 1e-3; one-device repeat "
          f"{abs(loss1b - loss1) / max(abs(loss1), 1e-30):.2e}); "
          f"|g_n - g_1|/|g_1| {rel_g:.2e} (tol 1e-2; one-device repeat "
          f"{rel_g_floor:.2e}); largest per-parameter: "
          + ", ".join(f"{k} {v:.1e}" for v, k in per_param), flush=True)
    check(np.isfinite(lossn) and rel_l <= 1e-3 and rel_g <= 1e-2,
          "sharded train step differs")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--multi-gpu", action="store_true",
                        help="run only the four-GPU sharded render and "
                             "train step against one GPU")
    args = parser.parse_args(argv)
    n_dev = 4 if args.multi_gpu else 1

    t_all = time.perf_counter()
    t0 = _phase("device")
    card, kind = phase_device(n_dev)
    _done("device", t0)

    import jax

    from path_tracer_tpu.scene.showcase import showcase_device_scene
    from path_tracer_tpu.utils.cache import cache_dir

    t0 = time.perf_counter()
    scene = showcase_device_scene(use_bvh=True, textured=True)
    print(f"textured showcase: {scene.num_real_triangles} triangles, "
          f"{scene.num_real_spheres} spheres, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    if args.multi_gpu:
        t0 = _phase("multi-gpu")
        phase_multi(scene, n_dev)
        _done("multi-gpu", t0)
    else:
        t0 = _phase("oracle")
        phase_oracle()
        _done("oracle", t0)
        t0 = _phase("kernel")
        phase_kernel(scene)
        _done("kernel", t0)
        t0 = _phase("render")
        phase_render(card, cache_dir("chip_smoke"))
        _done("render", t0)
        t0 = _phase("train")
        from path_tracer_tpu.scene.procedural import cornell_device_scene

        phase_train(scene,
                    showcase_device_scene(grid=96, use_bvh=True,
                                          textured=True),
                    cornell_device_scene())
        _done("train", t0)

    devs = jax.devices()
    print(f"all phases OK in {time.perf_counter() - t_all:.1f} s on {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
