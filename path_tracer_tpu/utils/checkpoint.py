"""Sample-chunk checkpointing of the accumulation buffer.

The reference keeps its accumulation buffer only in memory
(ref: src/renderer/mod.rs:81,105) — progressive passes exist but are never
persisted. For long renders (and the train-loop analog) we persist
(radiance sums, samples_done, config fingerprint) after every pass chunk;
resuming continues at the next sample id with identical results because the
RNG is counter-based per (pixel, sample) (ops/rng.py).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_VERSION = 1


def fingerprint(width: int, height: int, bounces: int, seed: int,
                scene, profile=None) -> str:
    """Config fingerprint over EVERY radiance-affecting input.

    Hashes every INPUT leaf of the DeviceScene array pytree (camera
    transform, lights, all material factors, textures, geometry) plus render
    dims / bounces / seed and — when a Profile is given — the tonemap and
    alpha/shadow walk depths. Guards against resuming a checkpoint into a
    different render.

    Derived acceleration tables (bvh_*, sl_*, *_packed_t) are deterministic
    functions of the hashed inputs, so skipping them loses no coverage and
    spares the device->host transfer of tens of MB of derived tables.
    """
    import dataclasses
    import hashlib

    import jax

    _DERIVED = ("bvh_", "sl_", "tri_packed_t", "sph_packed_t")
    h = hashlib.sha1()
    h.update(f"{_VERSION}|{width}x{height}|b{bounces}|s{seed}".encode())
    if profile is not None:
        h.update(f"|tm{profile.tonemap}|aw{profile.alpha_walk_steps}"
                 f"|sw{profile.shadow_walk_steps}".encode())
    for f in dataclasses.fields(scene):
        if f.name.startswith(_DERIVED[:2]) or f.name in _DERIVED[2:]:
            continue
        leaf = getattr(scene, f.name)
        if isinstance(leaf, (jax.Array, np.ndarray)):
            h.update(f.name.encode())
            h.update(np.asarray(leaf).tobytes())
        else:  # static config fields (ints/bools) affect radiance too
            h.update(f"|{f.name}={leaf}".encode())
    return h.hexdigest()[:16]


def save(path, accum: np.ndarray, samples_done: int, fp: str) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    np.savez_compressed(
        tmp, accum=accum, samples_done=np.int64(samples_done),
        meta=json.dumps({"version": _VERSION, "fingerprint": fp}),
    )
    # np.savez appends .npz to the name it opens; normalize then atomically
    # replace so a crash mid-write never corrupts the checkpoint.
    written = tmp if tmp.exists() else tmp.with_suffix(tmp.suffix + ".npz")
    written.replace(path)


def load(path, fp: str) -> Optional[Tuple[np.ndarray, int]]:
    """(accum, samples_done) or None if absent/mismatched."""
    path = Path(path)
    if not path.exists():
        return None
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("fingerprint") != fp:
            raise ValueError(
                f"checkpoint {path} was written by a different render config "
                f"({meta.get('fingerprint')} != {fp})"
            )
        return z["accum"].copy(), int(z["samples_done"])
