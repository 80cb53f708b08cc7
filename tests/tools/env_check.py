"""Hermetic-environment check — the flake.nix analog's enforcement half.

The reference pins its entire toolchain with a Nix flake (ref: flake.nix,
flake.lock); this image has no Nix, so the pin is ``constraints.txt`` and
this tool asserts the LIVE interpreter actually matches it: every pinned
package importable at exactly the pinned version, python 3.12, and a
working C++17 compiler for the native BVH builder. CI runs it first so a
version drift fails loudly instead of skewing golden/perf numbers.
"""
from __future__ import annotations

import importlib.metadata as md
import shutil
import subprocess
import sys
from pathlib import Path

CONSTRAINTS = Path(__file__).resolve().parents[2] / "constraints.txt"

def parse_pins() -> dict[str, str]:
    pins: dict[str, str] = {}
    for line in CONSTRAINTS.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, ver = line.partition("==")
        pins[name.strip()] = ver.strip()
    return pins


def check() -> list[str]:
    errors: list[str] = []
    if sys.version_info[:2] != (3, 12):
        errors.append(f"python {sys.version.split()[0]} != pinned 3.12.*")
    for name, want in parse_pins().items():
        try:
            got = md.version(name)
        except md.PackageNotFoundError:
            errors.append(f"{name}: not installed (pinned {want})")
            continue
        if got != want:
            errors.append(f"{name}: {got} != pinned {want}")
    gxx = shutil.which("g++")
    if gxx is None:
        errors.append("g++: not on PATH (needed for native/bvh.cpp)")
    else:
        out = subprocess.run([gxx, "-dumpversion"], capture_output=True,
                             text=True, check=False).stdout.strip()
        major = int(out.split(".")[0]) if out else 0
        if major < 12:
            errors.append(f"g++ {out}: < pinned floor 12 (C++17 required)")
    return errors


def main() -> int:
    errors = check()
    for e in errors:
        print(f"env_check: {e}", file=sys.stderr)
    if not errors:
        print(f"env_check: OK ({len(parse_pins())} pins match)")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
