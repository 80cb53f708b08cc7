"""Sharded wavefront rendering: pixel tiles over a device mesh.

Each device renders its shard of the flat pixel-id wavefront against the
replicated scene — the accelerator analog of rayon's work-stealing pixel loop
(ref: src/renderer/mod.rs:106), except the partition is static and the RNG is
counter-based per (pixel, sample) (ops/rng.py) so the image is independent of
the shard layout.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from path_tracer_tpu.models.integrator import IntegratorSpec, render_wavefront
from path_tracer_tpu.parallel.mesh import DP_AXIS


@partial(
    jax.jit,
    static_argnames=("mesh", "width", "height", "n_samples", "spec", "axis",
                     "rebalance"),
)
def render_sharded(scene, mesh, pixel_ids, width: int, height: int,
                   sample_start, n_samples: int, spec: IntegratorSpec,
                   axis: str = DP_AXIS, rebalance: bool = False):
    """Accumulate ``n_samples`` samples for a sharded wavefront.

    pixel_ids: [R] int32 with R divisible by the mesh size; returns the
    radiance **sum** [R, 3] (caller divides by total samples).

    rebalance=True turns on cross-shard live-ray rebalancing (SURVEY §2c
    "ray-queue rebalancing all_to_all"): before every bounce each shard
    partitions its lanes alive-first, deals them round-robin into one group
    per shard, and ``all_to_all`` exchanges the groups. Because alive lanes
    are a prefix of each source shard, every destination receives
    ⌈c_j/n⌉-or-⌊c_j/n⌋ live lanes from shard j — per-shard live counts
    equalize to the global mean after one exchange regardless of how
    unevenly paths die across the screen. Radiance is bit-identical either
    way (per-lane RNG keys travel with the lane); the cost is the exchange
    bandwidth + a final all_gather to route sums home, which on one host
    rides NVLink.
    """
    n_shards = mesh.shape[axis]

    def local(scene, ids):
        r_local = ids.shape[0]

        def body(acc, k):
            rad = render_wavefront(scene, ids, width, height,
                                   sample_start + k, spec)
            return acc + rad, None

        def body_rebalanced(acc, k):
            me = jax.lax.axis_index(axis)
            lane_ids = me * r_local + jnp.arange(r_local, dtype=jnp.int32)
            color, orig = render_wavefront(
                scene, ids, width, height, sample_start + k, spec,
                exchange=_alive_first_all_to_all(axis, n_shards),
                lane_ids=lane_ids)
            # Route each lane's radiance back to its home (shard, slot):
            # gather every shard's (color, orig) and keep rows homed here.
            allc = jax.lax.all_gather(color, axis).reshape(-1, 3)
            allo = jax.lax.all_gather(orig, axis).reshape(-1)
            slot = jnp.where(allo // r_local == me, allo % r_local, r_local)
            rad = jnp.zeros((r_local, 3), jnp.float32).at[slot].add(
                allc, mode="drop")
            return acc + rad, None

        init = jnp.zeros((r_local, 3), jnp.float32)
        acc, _ = jax.lax.scan(body_rebalanced if rebalance else body,
                              init, jnp.arange(n_samples))
        return acc

    # check_vma=False: the varying-manifest check would otherwise reject
    # replicated-vs-varying mixes in the scan carries.
    f = jax.shard_map(local, mesh=mesh, in_specs=(P(), P(axis)),
                      out_specs=P(axis), check_vma=False)
    return f(scene, pixel_ids)


def _alive_first_all_to_all(axis: str, n_shards: int):
    """Build the per-bounce exchange hook for render_wavefront.

    Each shard sorts lanes alive-first (stable), deals them round-robin into
    ``n_shards`` interleaved groups, and all_to_all sends group g to shard
    g. The round-robin deal is what balances: alive lanes sit at the front
    of every source's order, so each group carries an equal (±1) share of
    them. The deal is ROTATED by the source shard index (shard j's sorted
    lane i lands in group (i + j) mod n): without the rotation the ±1
    remainders all favor low group ids and destination 0 systematically
    collects every source's extra live lane (worst case +n); with it the
    remainder bias rotates across destinations and per-shard live counts
    land within ±1 lane of the global mean (pinned by
    test_rebalance_equalizes_live_lanes).
    """

    def exchange(state):
        alive = state[4]
        perm = jnp.argsort(~alive)  # stable: alive lanes first
        state = tuple(x[perm] for x in state)
        if n_shards == 1:
            return state

        r_local = alive.shape[0]
        if r_local % n_shards:
            raise ValueError(
                f"live-ray rebalancing needs the per-shard wavefront "
                f"({r_local} lanes) divisible by the mesh size ({n_shards}) "
                f"— the round-robin deal would otherwise drop lanes; pad R "
                f"to a multiple of mesh_size**2 or disable rebalance")
        me = jax.lax.axis_index(axis)
        g = jnp.arange(n_shards, dtype=jnp.int32)[:, None]
        k = jnp.arange(r_local // n_shards, dtype=jnp.int32)[None, :]
        deal = ((g - me) % n_shards) + k * n_shards  # [n, r/n] sorted idx

        def shuffle(x):
            groups = x[deal]  # [n, r/n, ...]
            groups = jax.lax.all_to_all(groups, axis, split_axis=0,
                                        concat_axis=0)
            return groups.reshape(r_local, *x.shape[1:])

        return tuple(shuffle(x) for x in state)

    return exchange


@partial(jax.jit, static_argnames=("mesh", "width", "height", "spec", "axis"))
def live_lane_counts(scene, mesh, pixel_ids, width: int, height: int,
                     sample_id, spec: IntegratorSpec, axis: str = DP_AXIS):
    """[n_shards, bounces+1] live-lane counts at the START of each bounce,
    per shard, for ONE un-rebalanced sample — the imbalance that
    cross-shard rebalancing (rebalance=True) removes; bench_scaling.py
    records them so the imbalance can be weighed against the exchange
    cost."""

    def local(scene, ids):
        _, live = render_wavefront(scene, ids, width, height, sample_id,
                                   spec, collect_live_counts=True)
        return live[None, :]

    f = jax.shard_map(local, mesh=mesh, in_specs=(P(), P(axis)),
                      out_specs=P(axis), check_vma=False)
    return f(scene, pixel_ids)
