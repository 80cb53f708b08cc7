"""Render profile and resolution config.

Reference parity: src/config/profile.rs:12-40 (YAML profile with defaults
1920x1080, bounces=4, samples=64, brdf=COOK_TORRANCE, tonemap=FILMIC) and
src/config/resolution.rs:4-16.

Additions (not in the reference): wavefront knobs that bound the
fixed-shape loops replacing the reference's variable-length hit lists
(src/renderer/utils.rs:11-21) — ``alpha_walk_steps`` for the stochastic alpha
transparency walk (src/renderer/mod.rs:188-205) and ``shadow_walk_steps`` for
opacity-attenuated shadow rays (src/renderer/mod.rs:291-329); plus
``tile_rays``, the number of rays processed per jitted wavefront launch.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Union

BRDF_TYPES = ("COOK_TORRANCE",)
TONEMAP_TYPES = ("REINHARD", "FILMIC", "ACES")


@dataclasses.dataclass(frozen=True)
class Resolution:
    width: int = 1920
    height: int = 1080

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


@dataclasses.dataclass(frozen=True)
class Profile:
    resolution: Resolution = Resolution()
    bounces: int = 4
    samples: int = 64
    brdf: str = "COOK_TORRANCE"
    tonemap: str = "FILMIC"
    # --- Wavefront knobs (beyond the reference) ---
    # Max closest-hit re-casts when walking stochastic alpha hits per bounce.
    # None (default) = auto: the scene's transparent-hit count + 1, which
    # makes the bounded walk EXACTLY equivalent to the reference's unbounded
    # sorted-hit iteration (mod.rs:188-205) — the while_loop early-exits, so
    # a large bound costs nothing at runtime. An explicit int truncates.
    alpha_walk_steps: int | None = None
    # Max occluder re-casts when accumulating shadow opacity attenuation.
    # Same auto semantics as alpha_walk_steps (ref mod.rs:283-331).
    shadow_walk_steps: int | None = None
    # Rays per jitted wavefront launch (pixel tile size, flattened).
    # Larger wavefronts amortize per-launch fixed costs. Values are
    # tile-size invariant — only throughput changes. MEMORY: per-launch
    # wavefront state scales linearly with this; lower it on small or
    # shared devices if a launch runs out of memory.
    tile_rays: int = 1 << 18
    # Samples accumulated per launch (inner sample batch).
    samples_per_launch: int = 1
    # Sample copies packed per kernel packet (shrinks the packet's screen
    # footprint by this factor; off by default; single-device only).
    samples_per_wavefront: int = 1
    # RNG seed (the reference derives streams from (pixel, sample) only,
    # src/renderer/mod.rs:110-112; we additionally mix a seed).
    seed: int = 0

    def __post_init__(self):
        if self.brdf not in BRDF_TYPES:
            raise ValueError(f"unknown brdf {self.brdf!r}, expected one of {BRDF_TYPES}")
        if self.tonemap not in TONEMAP_TYPES:
            raise ValueError(
                f"unknown tonemap {self.tonemap!r}, expected one of {TONEMAP_TYPES}"
            )

    @staticmethod
    def load(path: Union[str, Path]) -> "Profile":
        """Load a YAML render profile (ref: src/config/profile.rs:28-32).

        Accepts the reference's YAML schema::

            resolution: {width: 800, height: 600}
            bounces: 4
            samples: 16
            brdf: COOK_TORRANCE
            tonemap: FILMIC
        """
        with open(path) as f:
            raw = parse_profile_text(f.read())
        return Profile.from_dict(raw)

    @staticmethod
    def from_dict(raw: dict) -> "Profile":
        kwargs = {}
        if "resolution" in raw:
            res = raw["resolution"]
            kwargs["resolution"] = Resolution(int(res["width"]), int(res["height"]))
        for key in (
            "bounces",
            "samples",
            "alpha_walk_steps",
            "shadow_walk_steps",
            "tile_rays",
            "samples_per_launch",
            "samples_per_wavefront",
            "seed",
        ):
            if key in raw:
                # Only the walk depths are nullable (null = auto-size from
                # the scene); a null anywhere else is a config error and
                # must fail HERE with the key named, not at trace time.
                nullable = key in ("alpha_walk_steps", "shadow_walk_steps")
                if raw[key] is None and not nullable:
                    raise ValueError(f"profile key '{key}' must be an "
                                     f"integer, got null")
                kwargs[key] = None if raw[key] is None else int(raw[key])
        for key in ("brdf", "tonemap"):
            if key in raw:
                kwargs[key] = str(raw[key])
        return Profile(**kwargs)


def _scalar(text: str, where: str):
    """One YAML plain or quoted scalar -> None / bool / int / float / str."""
    t = text.strip()
    if t in ("", "~", "null", "Null", "NULL"):
        return None
    if t in ("true", "True", "TRUE"):
        return True
    if t in ("false", "False", "FALSE"):
        return False
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if t[0] in "[{&*!|>-?@`%" and not t.lstrip("+-").replace(".", "", 1).isdigit():
        raise ValueError(f"unsupported profile syntax at {where}: {t!r}")
    for conv in (int, float):
        try:
            return conv(t)
        except ValueError:
            pass
    return t


def _strip_comment(line: str) -> str:
    """Drop a '#' comment (at line start or after whitespace, outside
    quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _key_value(text: str, where: str):
    key, sep, value = text.partition(":")
    if not sep or not key.strip() or " " in key.strip():
        raise ValueError(f"unsupported profile syntax at {where}: {text!r}")
    return key.strip(), value.strip()


def parse_profile_text(text: str) -> dict:
    """Parse the render-profile subset of YAML: top-level ``key: scalar``
    lines, ``resolution`` (or any key) as a one-level mapping in block form
    (indented ``width: 800`` lines) or flow form (``{width: 800, height:
    600}``), ``#`` comments and a leading ``---``. Anything else raises
    ValueError naming the line."""
    out: dict = {}
    block_key = None
    for n, raw_line in enumerate(text.splitlines(), 1):
        where = f"line {n}"
        line = _strip_comment(raw_line).rstrip()
        if not line.strip() or (n == 1 and line.strip() == "---"):
            continue
        if "\t" in raw_line[: len(raw_line) - len(raw_line.lstrip())]:
            raise ValueError(f"tab indentation at {where}")
        if line[0] == " ":
            if block_key is None:
                raise ValueError(f"unexpected indentation at {where}")
            key, value = _key_value(line.strip(), where)
            out[block_key][key] = _scalar(value, where)
            continue
        key, value = _key_value(line, where)
        block_key = None
        if value == "":
            out[key] = {}
            block_key = key
        elif value.startswith("{"):
            if not value.endswith("}"):
                raise ValueError(f"unsupported profile syntax at {where}")
            items = [p for p in value[1:-1].split(",") if p.strip()]
            out[key] = dict(
                (k, _scalar(v, where))
                for k, v in (_key_value(p, where) for p in items))
        else:
            out[key] = _scalar(value, where)
    # A key with an empty value and no indented block is YAML null.
    return {k: (None if v == {} else v) for k, v in out.items()}
