"""Stateless counter-based RNG for the wavefront renderer.

The reference seeds an ``StdRng`` per (pixel, sample)
(ref: src/renderer/mod.rs:110-112) so results are independent of thread
scheduling. The wavefront equivalent must additionally be *shard-invariant*: a pixel
must get the same stream no matter which chip or tile renders it. We therefore
hash (pixel_id, sample_id, site, seed) directly with a counter-based mixer —
no sequential state at all. Streams are decorrelated and deterministic but NOT
bit-identical to the reference's (impossible and not required; see SURVEY §6).

``site`` is a static per-draw-site constant: every rand() call site in the
bounce loop gets its own site id, mirroring the reference's draw ordering
(alpha-accept per walk step, GGX r1/r2, russian roulette, camera jitter).

The mixer is a Threefry-inspired 2x32 block cipher reduced to mixing rounds of
rotate-xor-add over the (pixel, sample^site) pair — cheap, pure VPU integer
ops, passes the integrator's statistical furnace tests.
"""
from __future__ import annotations

import jax.numpy as jnp

# Distinct draw-site ids (static Python ints). Per-bounce sites are offset by
# SITE_STRIDE * bounce (or the widened stride from site_layout for deep
# alpha walks).
SITE_CAM_X = 0
SITE_CAM_Y = 1
SITE_STRIDE = 64
SITE_ALPHA = 2  # + walk step k (k < site_layout(steps) alpha capacity)
SITE_GGX_R1 = 40
SITE_GGX_R2 = 41
SITE_RR = 42


def site_layout(alpha_steps: int) -> tuple[int, int, int, int]:
    """(ggx_r1, ggx_r2, rr, stride) for a bounce whose alpha walk draws up
    to ``alpha_steps`` accept uniforms (static per trace).

    The historical layout (GGX at 40/41, RR at 42, stride 64) holds 38 walk
    sites; scenes whose auto-sized walk bound exceeds that (the bound is the
    scene's transparent-hit count + 1) would collide walk site 2+k with the
    bounce's GGX/RR draws — the accept decision and the scatter direction
    would reuse the SAME uniform, correlating the estimator. Deep walks
    therefore widen the whole layout; shallow walks keep the historical
    constants so existing streams (and frozen goldens) are bit-stable.
    """
    if alpha_steps <= SITE_GGX_R1 - SITE_ALPHA:
        return SITE_GGX_R1, SITE_GGX_R2, SITE_RR, SITE_STRIDE
    g1 = SITE_ALPHA + alpha_steps
    stride = ((g1 + 3) + 63) // 64 * 64
    return g1, g1 + 1, g1 + 2, stride


def _mix32(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """One-way mix of two uint32 streams (murmur3/splitmix-style finalizers)."""
    a = a.astype(jnp.uint32)
    b = b.astype(jnp.uint32)
    x = a * jnp.uint32(0xCC9E2D51) + (b ^ jnp.uint32(0x9E3779B9))
    x ^= x >> 16
    x = x * jnp.uint32(0x85EBCA6B)
    x ^= x >> 13
    x = x * jnp.uint32(0xC2B2AE35)
    x ^= x >> 16
    # Second round keyed by b to break (a, b) linearity.
    x = x + b * jnp.uint32(0x27D4EB2F)
    x ^= x >> 15
    x = x * jnp.uint32(0x2545F491)
    x ^= x >> 13
    return x


def uniform(pixel_id: jnp.ndarray, sample_id, site, seed: int) -> jnp.ndarray:
    """U[0,1) float32 per pixel lane. pixel_id: [R] int32; sample_id scalar;
    site may be a static int or a traced scalar (e.g. a scan counter)."""
    site_key = jnp.asarray(site, jnp.uint32) * jnp.uint32(0x01000193) + jnp.uint32(
        (seed * 0x61C88647) & 0xFFFFFFFF
    )
    key = jnp.asarray(sample_id, jnp.uint32) * jnp.uint32(0x9E3779B1) + site_key
    bits = _mix32(pixel_id.astype(jnp.uint32), key)
    # 24-bit mantissa → [0, 1)
    return (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))
