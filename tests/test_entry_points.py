"""Entry points as a user runs them, in fresh processes.

- A CLI render of ``head`` with Pillow and PyYAML made unimportable: the
  render path must need neither.
- ``chip_smoke.py`` must exit non-zero and print no result line off the
  GPU, both in the checkout and alone in an empty directory.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def test_render_without_pillow_or_yaml(tmp_path, reference_scenes):
    prof = tmp_path / "p.yaml"
    prof.write_text("resolution:\n  width: 24\n  height: 16\n"
                    "samples: 2\nbounces: 1\n")
    out = tmp_path / "head.png"
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "sys.modules['yaml'] = None\n"
        "from path_tracer_tpu import cli\n"
        f"cli.main(['render', {str(reference_scenes / 'head' / 'scene.isf')!r},"
        f" '-o', {str(out)!r}, '-p', {str(prof)!r}, '-q'])\n"
        "assert 'PIL' not in sys.modules or sys.modules['PIL'] is None\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    from path_tracer_tpu.utils.image_io import read_png

    img, mode = read_png(out)
    assert mode == "RGB" and img.shape == (16, 24, 3)
    assert np.asarray(img, np.float64).std() > 1.0


def _last_line_is_result(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return bool(json.loads(lines[-1]).get("ok"))
    except (ValueError, AttributeError):
        return False


def test_chip_smoke_fails_on_cpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert not _last_line_is_result(r.stdout)
    assert "no GPU found" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert not _last_line_is_result(r.stdout)
