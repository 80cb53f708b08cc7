"""Multi-host initialization and addressing helpers.

The reference is single-process (rayon threads only, SURVEY §2c). Scaling
beyond one host rides `jax.distributed` + the same 1-D `shard_map` mesh used
intra-host: pixel tiles shard globally, the scene replicates per chip, and
the only cross-host traffic is the gradient psum (and the final image
gather), which XLA routes over NVLink within a host and the network across
hosts.

Usage on each host::

    from path_tracer_tpu.parallel import multihost
    multihost.initialize(addr, n, i)    # coordinator, process count, rank
    mesh = multihost.global_mesh()      # 1-D mesh over ALL hosts' devices
    # render_sharded / make_train_step work unchanged with this mesh;
    # feed each host its addressable shard of the pixel-id array.
"""
from __future__ import annotations

import jax

from path_tracer_tpu.parallel.mesh import DP_AXIS


def initialize(coordinator_address=None, num_processes=None,
               process_id=None) -> None:
    """jax.distributed.initialize. Pass the coordinator address
    (``host:port``), the process count and this process's rank unless the
    cluster environment provides them.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh(axis_name: str = DP_AXIS):
    """1-D mesh over every device in the job (all hosts)."""
    devices = jax.devices()
    return jax.make_mesh((len(devices),), (axis_name,), devices=devices)


def local_pixel_slice(n_pix: int):
    """(start, stop) of this host's contiguous pixel range for a flat
    wavefront of n_pix ids sharded over the global mesh."""
    n_proc = jax.process_count()
    pid = jax.process_index()
    per = n_pix // n_proc
    start = pid * per
    stop = n_pix if pid == n_proc - 1 else start + per
    return start, stop


def render_multihost(scene, profile, mesh=None):
    """Public multi-process render: every participating process calls this
    (after ``initialize()``) with the same scene + profile and receives the
    FULL [H,W,3] uint8 image. Pixel lanes shard over the global mesh, the
    scene replicates, and the only cross-host traffic is the final
    all_gather of radiance sums (ICI within a slice, DCN across).

    The image is bit-identical to a single-process ``render()`` of the same
    scene/profile: the counter RNG keys off (pixel, sample), so radiance is
    shard-layout-invariant, and per-pixel sample sums accumulate in the same
    ascending sample order. Single-process callers fall through to the
    ordinary renderer.
    """
    import numpy as np

    if jax.process_count() == 1 and mesh is None:
        from path_tracer_tpu.models.renderer import render

        return render(scene, profile)

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from path_tracer_tpu.models.renderer import _finalize, integrator_spec
    from path_tracer_tpu.parallel.render import render_sharded

    if mesh is None:
        mesh = global_mesh()
    width, height = profile.resolution.width, profile.resolution.height
    n_pix = width * height
    n_dev = mesh.devices.size
    sharding = NamedSharding(mesh, P(DP_AXIS))
    spec = integrator_spec(profile)

    # Tile the frame and batch the samples exactly like the single-host
    # driver (renderer.render_pixel_sums): per-lane integrator state scales
    # with the wavefront, so one untiled 1080p x all-samples launch would
    # exhaust device memory where the tiled path works.
    tile = min(profile.tile_rays, n_pix)
    tile = ((tile + n_dev - 1) // n_dev) * n_dev  # device-divisible lanes
    n_tiles = (n_pix + tile - 1) // tile
    spl = max(1, profile.samples_per_launch)

    gather = jax.jit(jax.shard_map(
        lambda a: jax.lax.all_gather(a, DP_AXIS, axis=0, tiled=True),
        mesh=mesh, in_specs=P(DP_AXIS), out_specs=P(), check_vma=False))

    rows = np.zeros((n_tiles * tile, 3), np.float32)
    for t in range(n_tiles):
        g0 = t * tile
        # Each process contributes its contiguous slice of this tile's id
        # range (padding lanes re-render pixel 0; discarded below).
        start, stop = local_pixel_slice(tile)
        local_ids = np.arange(g0 + start, g0 + stop, dtype=np.int32)
        local_ids[local_ids >= n_pix] = 0
        ids = jax.make_array_from_process_local_data(sharding, local_ids,
                                                     (tile,))
        acc = None
        done = 0
        while done < profile.samples:
            k = min(spl, profile.samples - done)
            part = render_sharded(scene, mesh, ids, width, height,
                                  jnp.int32(1 + done), k, spec)
            acc = part if acc is None else acc + part
            done += k
        # Replicate this tile's radiance sums onto every process.
        rows[g0 : g0 + tile] = np.asarray(gather(acc).addressable_data(0))
    return _finalize(rows[:n_pix], profile.samples, profile, width, height)
