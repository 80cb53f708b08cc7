"""Top individual device ops of one profiled showcase sample pass.

Same trace plumbing as bench._stage_breakdown, but instead of kernel-family
buckets it prints the top-N leaf ops with their source lines — the tool for
deciding what "xla_other" actually is. Run on the GPU:

    python tests/tools/top_ops.py [N]
"""
from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

WIDTH, HEIGHT = 1920, 1080


def main() -> int:
    top_n = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    import jax

    from path_tracer_tpu.models.integrator import IntegratorSpec
    from path_tracer_tpu.models.renderer import render_pixel_sums
    from path_tracer_tpu.scene.showcase import showcase_device_scene
    from path_tracer_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    scene = showcase_device_scene(
        use_bvh=True,
        textured=os.environ.get("BENCH_SCENE", "showcase") == "showcase")
    spec = IntegratorSpec(bounces=5, differentiable=False)

    def run(n, start):
        return render_pixel_sums(scene, WIDTH, HEIGHT, start, n, spec,
                                 tile_rays=1 << 19, samples_per_launch=4,
                                 snapshot=False)

    def sync(accs):
        jax.block_until_ready(accs)

    sync(run(1, 1))  # compile outside the trace
    d = tempfile.mkdtemp(prefix="pt_top_ops_")
    with jax.profiler.trace(d):
        sync(run(1, 999))
    found = glob.glob(d + "/plugins/profile/*/*.trace.json.gz")
    if not found:
        print(f"no trace produced under {d}", file=sys.stderr)
        return 1
    data = json.load(gzip.open(found[0], "rt"))
    shutil.rmtree(d, ignore_errors=True)
    agg = collections.Counter()
    srcs = {}
    total = 0.0
    for e in data["traceEvents"]:
        if e.get("ph") != "X" or "dur" not in e or "args" not in e:
            continue
        name = e.get("name", "")
        src = e["args"].get("source", "")
        if not src or "path_tracer_tpu" not in src:
            if not name.startswith(("bvh_closest", "bvh_anyhit")):
                continue
        if name.startswith(("while", "cond", "jit")):
            continue
        # Strip trailing .N dedup suffixes so repeated instances aggregate;
        # key by (opname, source line) so distinct fusions stay distinct.
        base = re.sub(r"\.\d+$", "", name)
        key = (base, src)
        agg[key] += e["dur"]
        total += e["dur"]
    print(f"total profiled device-op time: {total / 1e3:.1f} ms")
    for (name, src), dur in agg.most_common(top_n):
        flag = ("" if name.startswith(("bvh_closest", "bvh_anyhit"))
                else "  <-- xla_other")
        print(f"{dur / 1e3:9.2f} ms  {100 * dur / total:5.1f}%  {name[:40]:40s}"
              f" {src[-55:]}{flag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
