"""Render driver: tiles x samples host loop around the jitted wavefront.

Plays the role of Renderer::render (ref: src/renderer/mod.rs:76-169): an
accumulation buffer over pixels, one pass per sample, then post-processing
(tonemap + gamma + u8). The rayon par_iter over pixels (mod.rs:106) becomes a
flat pixel-id wavefront; tiles bound device memory for the O(rays x tris)
brute-force path and become the sharding unit across chips.

Accumulation lives on device (donated buffers) — launches stay async and the
only host transfer is the final image (or a per-pass snapshot for the
progressive viewer).
"""
from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from path_tracer_tpu.config import Profile
from path_tracer_tpu.models.integrator import IntegratorSpec, render_wavefront
from path_tracer_tpu.ops import tonemap as tm
# Lanes per BVH-kernel program: the packet that samples-per-wavefront packing
# (``spw``) shapes.
from path_tracer_tpu.ops.bvh_triton import BLOCK_RAYS as RAY_TILE


def integrator_spec(profile: Profile) -> IntegratorSpec:
    return IntegratorSpec(
        bounces=profile.bounces,
        alpha_walk_steps=profile.alpha_walk_steps,
        shadow_walk_steps=profile.shadow_walk_steps,
        seed=profile.seed,
        # Pure rendering: skip the AD-only reparameterization and read baked
        # material rows (identical radiance, cheaper bounce; integrator.py).
        differentiable=False,
    )


@partial(jax.jit,
         static_argnames=("width", "height", "n_samples", "spec", "spw"),
         donate_argnums=(0,))
def _accumulate_tile(acc, scene, pixel_ids, width, height, sample_start,
                     n_samples, spec, spw=1):
    """acc [P,3] += sum of n_samples successive samples for one tile.

    With ``spw`` > 1 (samples-per-wavefront packing), ``pixel_ids`` holds
    each pixel ``spw`` times — every RAY_TILE-lane kernel packet covers
    RAY_TILE/spw pixels x spw consecutive sample ids — so a packet's screen
    footprint (and the divergence of its BVH walk) shrinks by spw. The
    per-(pixel, sample) RNG streams are IDENTICAL to the spw=1 schedule:
    only the float accumulation order changes.
    """
    if spw == 1:
        def body(carry, k):
            rad = render_wavefront(scene, pixel_ids, width, height,
                                   sample_start + k, spec)
            return carry + rad, None

        acc, _ = jax.lax.scan(body, acc, jnp.arange(n_samples))
        return acc

    assert n_samples % spw == 0, (n_samples, spw)
    assert not spec.compact, "spw>1 permutes lanes' sample ids under compact"
    sb = RAY_TILE // spw  # pixels per kernel packet
    r = pixel_ids.shape[0]
    lane_off = jnp.tile(jnp.repeat(jnp.arange(spw, dtype=jnp.int32), sb),
                        r // RAY_TILE)

    def body(carry, k):
        sid = sample_start + k * spw + lane_off  # per-lane sample ids
        rad = render_wavefront(scene, pixel_ids, width, height, sid, spec)
        # Reduce the spw sample copies of each pixel: [K, spw, sb, 3] lanes.
        rad = rad.reshape(-1, spw, sb, 3).sum(axis=1).reshape(-1, 3)
        return carry + rad, None

    acc, _ = jax.lax.scan(body, acc, jnp.arange(n_samples // spw))
    return acc


def render_pixel_sums(scene, width: int, height: int, sample_start: int,
                      n_samples: int, spec: IntegratorSpec,
                      tile_rays: int = 1 << 16,
                      samples_per_launch: int = 1,
                      pass_callback=None,
                      init_accum: np.ndarray | None = None,
                      snapshot: bool = True,
                      samples_per_wavefront: int = 1) -> np.ndarray:
    """Radiance sums [W*H, 3] over n_samples consecutive sample ids.

    The tiles x sample-batches launch loop without post-processing — used by
    the renderer, the benchmark, and checkpointed renders. ``pass_callback``
    (if given) is called as cb(samples_done, accum_fn) after each sample
    batch, where accum_fn() transfers the current [W*H,3] sums to host; a
    callback returning False STOPS the render after that batch (the
    viewer's interactive stop) — the returned sums then cover only the
    samples completed so far.

    ``snapshot=False`` skips the final device->host transfer and returns the
    raw per-tile device accumulators (Morton pixel order) instead, for
    callers that only need completion (benchmarks keep the timed region
    free of the full-image transfer).
    """
    n_pix = width * height
    n_dev = len(jax.devices())
    spw = max(1, samples_per_wavefront)

    if spw > 1 and (n_dev > 1 or spec.compact or n_samples % spw != 0
                    or RAY_TILE % spw != 0 or tile_rays % RAY_TILE != 0
                    or tile_rays // spw > n_pix):
        # Packing needs: single device (render_sharded shards lanes, not
        # pixel/sample pairs), no lane-permuting compaction, a sample count
        # it divides, and RAY_TILE-aligned tiles no bigger than the frame.
        print(f"[renderer] samples_per_wavefront={spw} unsupported for this "
              f"config; falling back to 1", flush=True)
        spw = 1
    tile = min(tile_rays, max(1, n_pix)) if spw == 1 else tile_rays
    if n_dev > 1:
        # Round the tile up to a device multiple so every tile can shard
        # across the mesh (padded lanes render pixel 0 and are discarded).
        tile = ((tile + n_dev - 1) // n_dev) * n_dev
    tpix = tile // spw  # distinct pixels per launch
    n_tiles = (n_pix + tpix - 1) // tpix
    spl = max(1, samples_per_launch)
    if spw > 1:
        spl = max(spw, (spl // spw) * spw)  # batches must divide by spw

    # Pixels stream in HOST-computed Morton (16x16 screen tile) order: ray
    # packets then cover screen squares, which makes every cast's wavefront
    # coherent for free, with no per-cast sort+gather
    # (ops/sorting.morton_pixel_order).
    from path_tracer_tpu.ops.sorting import morton_pixel_order

    morton = morton_pixel_order(width, height)
    all_pix = np.zeros(n_tiles * tpix, dtype=np.int32)
    all_pix[:n_pix] = morton  # padded lanes re-render pixel 0; discarded
    if spw == 1:
        all_ids = all_pix
    else:
        # Each RAY_TILE-lane kernel packet = (RAY_TILE/spw) consecutive
        # pixels x spw sample copies (per-lane offsets: _accumulate_tile).
        sb = RAY_TILE // spw
        all_ids = np.repeat(all_pix.reshape(-1, 1, sb), spw,
                            axis=1).reshape(-1)
    tile_ids = [jnp.asarray(all_ids[t * tile : (t + 1) * tile])
                for t in range(n_tiles)]
    if init_accum is not None:
        padded = np.zeros((n_tiles * tpix, 3), np.float32)
        padded[:n_pix] = init_accum[morton]
        accs = [jnp.asarray(padded[t * tpix : (t + 1) * tpix])
                for t in range(n_tiles)]
    else:
        accs = [jnp.zeros((tpix, 3), jnp.float32) for _ in range(n_tiles)]

    # Multi-device: route tiles through the shard_map renderer (pixel lanes
    # sharded, scene replicated; the counter-based RNG makes results
    # layout-invariant). GSPMD auto-sharding cannot infer the scene-table
    # gathers, so the explicit shard_map path is used.
    devices = jax.devices()
    mesh = None
    if len(devices) > 1:
        # Always divisible: the tile was rounded up to a device multiple
        # above, so the shard_map path is unconditional on multi-device.
        from path_tracer_tpu.parallel.mesh import default_mesh

        mesh = default_mesh()

    def take_snapshot():
        rows = np.concatenate([np.asarray(a) for a in accs], axis=0)[:n_pix]
        out = np.empty_like(rows)
        out[morton] = rows  # back to linear pixel order
        return out

    sample = sample_start
    end = sample_start + n_samples
    while sample < end:
        k = min(spl, end - sample)
        for ti in range(n_tiles):
            if mesh is not None:
                from path_tracer_tpu.parallel.render import render_sharded

                accs[ti] = accs[ti] + render_sharded(
                    scene, mesh, tile_ids[ti], width, height,
                    jnp.int32(sample), k, spec)
            else:
                accs[ti] = _accumulate_tile(accs[ti], scene, tile_ids[ti],
                                            width, height, jnp.int32(sample),
                                            k, spec, spw=spw)
        sample += k
        if pass_callback is not None:
            if pass_callback(sample - sample_start, take_snapshot) is False:
                break
    if not snapshot:
        return accs
    return take_snapshot()


def render(scene, profile: Profile, progress: bool = False,
           viewer=None, checkpoint_path=None,
           checkpoint_every: int = 0) -> np.ndarray:
    """Render a scene → [H,W,3] uint8. Accumulates radiance over
    profile.samples (sample ids run 1..=samples as in ref mod.rs:105).

    With ``checkpoint_path``, the accumulation buffer is persisted every
    ``checkpoint_every`` samples (default: every pass batch) and a matching
    existing checkpoint resumes the render at the next sample id.
    """
    width, height = profile.resolution.width, profile.resolution.height
    spec = integrator_spec(profile)

    init_accum = None
    samples_done = 0
    fp = None
    if checkpoint_path is not None:
        from path_tracer_tpu.utils import checkpoint as ckpt

        fp = ckpt.fingerprint(width, height, profile.bounces, profile.seed,
                              scene, profile=profile)
        loaded = ckpt.load(checkpoint_path, fp)
        if loaded is not None:
            init_accum, samples_done = loaded
            samples_done = min(samples_done, profile.samples)

    t0 = time.time()
    bar = _ProgressBar(profile.samples, enabled=progress)
    bar.set(samples_done)
    last_saved = samples_done
    stopped_at = None  # early interactive stop (viewer Stop button)

    def on_pass(done_in_run, snapshot):
        nonlocal last_saved, stopped_at
        done = samples_done + done_in_run
        if viewer is not None:
            rays = (width * height * done_in_run * (profile.bounces + 1))
            img = _finalize(snapshot(), done, profile, width, height)
            if _viewer_takes_progress(viewer):
                viewer.update(img, samples_done=done,
                              samples_total=profile.samples, rays_done=rays)
            else:  # minimal viewers: update(image) only
                viewer.update(img)
        if checkpoint_path is not None and (
            checkpoint_every <= 0 or done - last_saved >= checkpoint_every
            or done >= profile.samples
        ):
            from path_tracer_tpu.utils import checkpoint as ckpt

            ckpt.save(checkpoint_path, snapshot(), done, fp)
            last_saved = done
        bar.set(done)
        if viewer is not None and getattr(viewer, "stop_requested", False):
            # Stop after this batch; finalize over the samples accumulated.
            stopped_at = done
            return False
        return True

    if samples_done < profile.samples:
        accum = render_pixel_sums(
            scene, width, height, samples_done + 1,
            profile.samples - samples_done, spec,
            tile_rays=profile.tile_rays,
            samples_per_launch=profile.samples_per_launch,
            samples_per_wavefront=profile.samples_per_wavefront,
            pass_callback=on_pass,
            init_accum=init_accum,
        )
    else:
        accum = init_accum

    total_samples = stopped_at if stopped_at is not None else profile.samples
    elapsed = time.time() - t0
    n_rays = width * height * (total_samples - samples_done) \
        * (profile.bounces + 1)
    verb = "Stopped" if stopped_at is not None else "Done"
    bar.finish(f"{verb}: {elapsed:.1f}s "
               f"({n_rays / max(elapsed, 1e-9) / 1e6:.1f} Mray/s)")
    return _finalize(accum, total_samples, profile, width, height)


def _viewer_takes_progress(viewer) -> bool:
    """Signature check done ONCE per viewer type (a bare except TypeError
    around update() would misclassify TypeErrors raised INSIDE a viewer)."""
    import inspect

    try:
        return "samples_done" in inspect.signature(viewer.update).parameters
    except (TypeError, ValueError):
        return False


def _finalize(accum: np.ndarray, samples: int, profile: Profile, width, height):
    mean = jnp.asarray(accum) / float(samples)
    post = tm.post_process(profile.tonemap, mean)
    u8 = np.asarray(tm.to_u8(post))
    return u8.reshape(height, width, 3)


class _ProgressBar:
    """Per-sample progress line (ref: pbr bar, mod.rs:84-91,144-146)."""

    def __init__(self, total: int, enabled: bool):
        self.total = total
        self.done = 0
        self.enabled = enabled
        self.t0 = time.time()
        if enabled:
            self._draw()

    def _draw(self):
        frac = self.done / max(1, self.total)
        n = int(frac * 40)
        print(f"\rRendering: [{'#' * n}{'-' * (40 - n)}] "
              f"{self.done}/{self.total} ({time.time() - self.t0:.0f}s)",
              end="", flush=True)

    def set(self, done: int):
        self.done = done
        if self.enabled:
            self._draw()

    def advance(self, k=1):
        self.set(self.done + k)

    def finish(self, msg: str):
        if self.enabled:
            print(f"\r{msg}{' ' * 60}")
