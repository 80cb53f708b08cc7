"""ctypes loader + Python entry for the C++ BVH builder (native/bvh.cpp).

Compiles the shared library on first use with g++ -O3 (plain C ABI +
ctypes, no pybind11) and caches the .so under the checkout's ``.cache/native``
keyed on a source hash.
"""
from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np

_SRC = Path(__file__).parent / "bvh.cpp"
_LIB = None


def _compile() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:16]
    from path_tracer_tpu.utils.cache import cache_dir

    so_path = cache_dir("native") / f"libptt_bvh_{digest}.so"
    if not so_path.exists():
        tmp = so_path.with_suffix(f".{id(object())}.tmp.so")
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             str(_SRC), "-o", str(tmp)],
            check=True, capture_output=True,
        )
        tmp.replace(so_path)  # atomic vs concurrent builders
    return so_path


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_compile()))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.ptt_build_bvh.restype = ctypes.c_int
        lib.ptt_build_bvh.argtypes = [
            f32p, f32p, ctypes.c_int, ctypes.c_int,
            f32p, f32p, i32p, i32p, i32p, i32p,
        ]
        _LIB = lib
    return _LIB


class Bvh(NamedTuple):
    """Flattened skip-pointer BVH (DFS order; hit → i+1, miss → skip[i])."""

    node_min: np.ndarray  # [N,3] f32
    node_max: np.ndarray  # [N,3] f32
    first_prim: np.ndarray  # [N] i32 (leaves; 0 for internal)
    prim_count: np.ndarray  # [N] i32 (0 for internal nodes)
    skip: np.ndarray  # [N] i32 escape index (N at the root tail)
    prim_order: np.ndarray  # [n_prims] i32 permutation into the input prims


def build_bvh(bb_min: np.ndarray, bb_max: np.ndarray,
              leaf_size: int = 4) -> Bvh:
    """Binned-SAH BVH over n primitive AABBs ([n,3] f32 min/max)."""
    bb_min = np.ascontiguousarray(bb_min, np.float32)
    bb_max = np.ascontiguousarray(bb_max, np.float32)
    n = bb_min.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over zero primitives")

    cap = 2 * n
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    first_prim = np.empty(cap, np.int32)
    prim_count = np.empty(cap, np.int32)
    skip = np.empty(cap, np.int32)
    prim_order = np.empty(n, np.int32)

    n_nodes = _lib().ptt_build_bvh(
        bb_min, bb_max, n, int(leaf_size),
        node_min, node_max, first_prim, prim_count, skip, prim_order,
    )
    assert 0 < n_nodes <= cap
    return Bvh(
        node_min=node_min[:n_nodes].copy(),
        node_max=node_max[:n_nodes].copy(),
        first_prim=first_prim[:n_nodes].copy(),
        prim_count=prim_count[:n_nodes].copy(),
        skip=skip[:n_nodes].copy(),
        prim_order=prim_order,
    )
