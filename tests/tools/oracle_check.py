"""Accelerator renders vs the independent scalar oracle's frozen goldens.

tests/test_oracle_parity.py runs the same comparison on the CPU (jnp walks);
this tool runs it on the GPU, where BVH scenes walk with the compiled Triton
kernels, closing the gap between "kernels match the jnp walk" and "GPU
images match the reference semantics". Same frozen goldens and tolerances
(the comparison is statistical — different RNG streams — so kernel rounding
needs no extra slack).

    python tests/tools/oracle_check.py [case ...]

Off the GPU it exits non-zero without rendering. Exit 0 = every case OK.
chip_smoke.py calls ``check_cases``.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# Every kernel family and integrator feature: brute-force scan (cube, head),
# spheres, deep alpha walks, Russian roulette, the partitioned textured
# showcase, the BVH-walked converted GLBs (one with two opacity textures),
# the mirror path and both furnaces.
DEFAULT_CASES = ("cube", "head", "spheres", "alpha_transparency",
                 "cube_rr_b6", "showcase_tex", "glb_converted_512",
                 "reflection", "white_furnace_direct",
                 "white_furnace_indirect", "glb_multi_opacity")


def check_case(case: str) -> tuple[bool, str]:
    """Render one golden case on the current backend and compare it with
    the oracle under the CPU gate's tolerances. Returns (ok, summary)."""
    from tests.oracle.case_scenes import resolve_scene
    from tests.oracle.reference_oracle import post_process
    from tests.test_oracle_parity import CASES, GOLDEN, _render_wavefront

    z = np.load(GOLDEN / f"{case}.npz")
    oracle = z["radiance"].astype(np.float64)
    w, h, spp, bounces = (int(z["width"]), int(z["height"]),
                          int(z["spp"]), int(z["bounces"]))
    tol, walk, energy_rtol = CASES[case]
    wave = _render_wavefront(resolve_scene(str(z["scene"])), w, h, spp,
                             bounces, walk)
    finite = (np.isfinite(oracle).all(axis=-1)
              & np.isfinite(wave).all(axis=-1))
    om = oracle[finite].mean()
    wm = wave[finite].mean()
    o8 = post_process("FILMIC", oracle).astype(np.int64)
    w8 = post_process("FILMIC", np.maximum(wave, 0.0)).astype(np.int64)
    diff = np.abs(o8 - w8)[finite]
    ok = bool(finite.mean() > 0.99
              and abs(om - wm) <= max(energy_rtol * om, 5e-4)
              and diff.mean() <= tol
              and np.percentile(diff, 99) <= 40)
    return ok, (f"mean|u8|={diff.mean():.2f} (tol {tol}) "
                f"p99={np.percentile(diff, 99):.0f} (tol 40) "
                f"energy {wm:.4f} vs {om:.4f} (rtol {energy_rtol})")


def check_cases(cases=DEFAULT_CASES) -> list[str]:
    """Run every case, print one OK/FAIL line each; return the failures."""
    failures = []
    for case in cases:
        ok, summary = check_case(case)
        print(f"oracle {case}: {'OK' if ok else 'FAIL'} {summary}",
              flush=True)
        if not ok:
            failures.append(case)
    return failures


def main(cases) -> int:
    import jax

    from path_tracer_tpu.utils.cache import enable_compilation_cache

    if jax.default_backend() != "gpu":
        print(f"oracle_check: needs the GPU, found backend "
              f"{jax.default_backend()!r} (the CPU gate is "
              f"tests/test_oracle_parity.py)", file=sys.stderr)
        return 2
    enable_compilation_cache()
    failures = check_cases(cases)
    if failures:
        print(f"FAILURES: {failures}")
        return 1
    print(f"all {len(cases)} GPU renders match the oracle goldens")
    return 0


if __name__ == "__main__":
    sys.exit(main(tuple(sys.argv[1:]) or DEFAULT_CASES))
