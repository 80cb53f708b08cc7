"""Time the per-run setup inside render_pixel_sums vs the launch loop.

bench.py times render_pixel_sums end to end. This isolates where host-side
time lives: morton ordering, host id packing, tile-id uploads, acc init, or
the launch loop itself. Run on the GPU:

    python tests/tools/setup_cost.py
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from path_tracer_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    from path_tracer_tpu.models.integrator import IntegratorSpec
    from path_tracer_tpu.models.renderer import (_accumulate_tile,
                                                 render_pixel_sums)
    from path_tracer_tpu.ops.sorting import morton_pixel_order
    from path_tracer_tpu.scene.showcase import showcase_device_scene

    scene = showcase_device_scene(use_bvh=True)
    W, H = 1920, 1080
    tile = 1 << 18
    spec = IntegratorSpec(bounces=5, differentiable=False)
    n_pix = W * H
    n_tiles = (n_pix + tile - 1) // tile
    SAMPLES = 16
    SPL = 4

    # warm compile
    acc = _accumulate_tile(jnp.zeros((tile, 3), jnp.float32), scene,
                           jnp.zeros((tile,), jnp.int32), W, H,
                           jnp.int32(1), SPL, spec)
    acc.block_until_ready()

    def t(label, fn, n=3):
        best = min(timeit(fn) for _ in range(n))
        print(f"{label:34s} {best * 1e3:9.1f} ms", flush=True)
        return best

    def timeit(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t("morton_pixel_order", lambda: morton_pixel_order(W, H))
    morton = morton_pixel_order(W, H)

    def pack_ids():
        all_ids = np.zeros(n_tiles * tile, dtype=np.int32)
        all_ids[:n_pix] = morton
        return all_ids

    t("host id packing", pack_ids)
    all_ids = pack_ids()

    def upload():
        tids = [jnp.asarray(all_ids[i * tile : (i + 1) * tile])
                for i in range(n_tiles)]
        for x in tids:
            x.block_until_ready()
        return tids

    t("tile-id upload (8x1MB)", upload)
    tile_ids = upload()

    def accs_init():
        accs = [jnp.zeros((tile, 3), jnp.float32) for _ in range(n_tiles)]
        for a in accs:
            a.block_until_ready()
        return accs

    t("acc zeros init", accs_init)

    def loop():
        accs = [jnp.zeros((tile, 3), jnp.float32) for _ in range(n_tiles)]
        s = 1
        while s <= SAMPLES:
            k = min(SPL, SAMPLES - s + 1)
            for i in range(n_tiles):
                accs[i] = _accumulate_tile(accs[i], scene, tile_ids[i],
                                           W, H, jnp.int32(s), k, spec)
            s += k
        jax.block_until_ready(accs)

    dt = t("launch loop (16spp, ids hoisted)", loop, n=2)
    print(f"  -> {n_pix * SAMPLES * 6 / dt / 1e6:.2f} Mray/s", flush=True)

    def full():
        accs = render_pixel_sums(scene, W, H, 1, SAMPLES, spec,
                                 tile_rays=tile, samples_per_launch=SPL,
                                 snapshot=False)
        jax.block_until_ready(accs)

    dt = t("render_pixel_sums (bench path)", full, n=2)
    print(f"  -> {n_pix * SAMPLES * 6 / dt / 1e6:.2f} Mray/s", flush=True)

    # verbatim body of render_pixel_sums (single-device path) with timers
    def inline(fresh_ids: bool):
        t0 = time.perf_counter()
        morton = morton_pixel_order(W, H)
        ids = np.zeros(n_tiles * tile, dtype=np.int32)
        ids[:n_pix] = morton
        if fresh_ids:
            tids = [jnp.asarray(ids[i * tile : (i + 1) * tile])
                    for i in range(n_tiles)]
        else:
            tids = tile_ids
        accs = [jnp.zeros((tile, 3), jnp.float32) for _ in range(n_tiles)]
        t1 = time.perf_counter()
        s = 1
        while s <= SAMPLES:
            k = min(SPL, SAMPLES - s + 1)
            for i in range(n_tiles):
                accs[i] = _accumulate_tile(accs[i], scene, tids[i],
                                           W, H, jnp.int32(s), k, spec)
            s += k
        jax.block_until_ready(accs)
        t2 = time.perf_counter()
        print(f"inline fresh_ids={int(fresh_ids)}: setup {t1-t0:6.2f}s "
              f"loop {t2-t1:6.2f}s -> "
              f"{n_pix * SAMPLES * 6 / (t2-t0) / 1e6:.2f} Mray/s", flush=True)

    for fresh in (False, True, False, True):
        inline(fresh)


if __name__ == "__main__":
    main()
